// fugue-tpu native host runtime: independent diagnostics backend.
//
// Role (mirrors the reference's discipline of double-deriving its reference
// values with an independent implementation, tests/gen_refs.py): a C++
// implementation of the convergence estimators — Geyer-truncated ESS,
// split-R-hat, Gelman-Rubin pooled variance, batched quantiles — computed
// directly (O(n·lag) autocovariance loops, exact selection quantiles) with
// compensated summation. Used (a) by the test suite to cross-validate the
// XLA/FFT implementations, and (b) for host-side post-processing of large
// sample dumps without touching the accelerator.
//
// C ABI only (loaded via ctypes). All arrays are contiguous float64.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Kahan-compensated mean.
static double kmean(const double* x, int64_t n) {
  double sum = 0.0, c = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double y = x[i] - c;
    double t = sum + y;
    c = (t - sum) - y;
    sum = t;
  }
  return sum / static_cast<double>(n);
}

static double kvar(const double* x, int64_t n, double mean, int64_t ddof) {
  double sum = 0.0, c = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double d = x[i] - mean;
    double y = d * d - c;
    double t = sum + y;
    c = (t - sum) - y;
    sum = t;
  }
  return sum / static_cast<double>(n - ddof);
}

// Biased (1/n) autocovariance at a single lag.
static double acov_at(const double* x, int64_t n, double mean, int64_t lag) {
  double sum = 0.0, c = 0.0;
  for (int64_t i = 0; i + lag < n; ++i) {
    double y = (x[i] - mean) * (x[i + lag] - mean) - c;
    double t = sum + y;
    c = (t - sum) - y;
    sum = t;
  }
  return sum / static_cast<double>(n);
}

// Single-chain ESS with the Geyer initial-positive-monotone sequence,
// lag cap 2048. Returns ESS in [0, n].
double ft_ess(const double* x, int64_t n) {
  if (n < 4) return static_cast<double>(n);
  double mean = kmean(x, n);
  double var0 = acov_at(x, n, mean, 0);
  if (!(var0 > 0.0)) return 0.0;
  int64_t max_lag = std::min<int64_t>(n - 1, 2048);

  double tau = 0.0;     // -1 + 2 * sum of kept pair sums (pair 0 included)
  double prev_pair = 1e300;
  double acc = 0.0;
  for (int64_t k = 0; 2 * k + 1 <= max_lag; ++k) {
    double r0 = acov_at(x, n, mean, 2 * k) / var0;
    double r1 = acov_at(x, n, mean, 2 * k + 1) / var0;
    double pair = r0 + r1;
    if (pair <= 0.0) break;                 // initial positive sequence
    if (pair > prev_pair) pair = prev_pair; // monotone non-increasing
    prev_pair = pair;
    acc += pair;
  }
  tau = -1.0 + 2.0 * acc;
  if (tau < 1e-12) tau = 1e-12;
  double ess = static_cast<double>(n) / tau;
  if (ess > static_cast<double>(n)) ess = static_cast<double>(n);
  return ess;
}

// Batched single-chain ESS: rows of an (m, n) matrix.
void ft_ess_batch(const double* x, int64_t m, int64_t n, double* out) {
  for (int64_t i = 0; i < m; ++i) out[i] = ft_ess(x + i * n, n);
}

// Gelman-Rubin R-hat over m chains of length n (classic, not split).
double ft_rhat(const double* chains, int64_t m, int64_t n) {
  if (m < 2 || n < 2) return 1.0;
  std::vector<double> means(m), vars(m);
  for (int64_t i = 0; i < m; ++i) {
    means[i] = kmean(chains + i * n, n);
    vars[i] = kvar(chains + i * n, n, means[i], 1);
  }
  double w = kmean(vars.data(), m);
  double grand = kmean(means.data(), m);
  double b = static_cast<double>(n) * kvar(means.data(), m, grand, 1);
  double var_plus =
      (static_cast<double>(n - 1) / n) * w + b / static_cast<double>(n);
  if (!(w > 0.0)) return 1.0;
  return std::sqrt(var_plus / w);
}

// Split-R-hat: halve each chain then classic R-hat over 2m half-chains.
double ft_split_rhat(const double* chains, int64_t m, int64_t n) {
  int64_t half = n / 2;
  if (half < 2) return 1.0;
  std::vector<double> split(2 * m * half);
  for (int64_t i = 0; i < m; ++i) {
    std::memcpy(split.data() + (2 * i) * half, chains + i * n,
                half * sizeof(double));
    std::memcpy(split.data() + (2 * i + 1) * half, chains + i * n + (n - half),
                half * sizeof(double));
  }
  return ft_rhat(split.data(), 2 * m, half);
}

// Batched exact quantiles by selection: for each of q quantile levels,
// nth_element on a scratch copy (linear-interpolated, numpy convention).
void ft_quantiles(const double* x, int64_t n, const double* qs, int64_t nq,
                  double* out) {
  std::vector<double> scratch(x, x + n);
  for (int64_t j = 0; j < nq; ++j) {
    double pos = qs[j] * static_cast<double>(n - 1);
    int64_t lo = static_cast<int64_t>(std::floor(pos));
    int64_t hi = std::min<int64_t>(lo + 1, n - 1);
    double frac = pos - static_cast<double>(lo);
    std::nth_element(scratch.begin(), scratch.begin() + lo, scratch.end());
    double vlo = scratch[lo];
    double vhi = vlo;
    if (hi != lo) {
      vhi = *std::min_element(scratch.begin() + lo + 1, scratch.end());
    }
    out[j] = vlo + frac * (vhi - vlo);
  }
}

// Multi-chain ESS (Vehtari pooled-variance normalization), matching
// inference/mcmc_utils.ess_multichain.
double ft_ess_multichain(const double* chains, int64_t m, int64_t n) {
  if (m < 1 || n < 4) return static_cast<double>(m * n);
  std::vector<double> means(m), vars(m);
  for (int64_t i = 0; i < m; ++i) {
    means[i] = kmean(chains + i * n, n);
    vars[i] = kvar(chains + i * n, n, means[i], 1);
  }
  double w = kmean(vars.data(), m);
  double b = 0.0;
  if (m > 1) {
    double grand = kmean(means.data(), m);
    b = static_cast<double>(n) * kvar(means.data(), m, grand, 1);
  }
  double var_plus =
      (static_cast<double>(n - 1) / n) * w + b / static_cast<double>(n);
  if (!(var_plus > 0.0)) return 0.0;

  int64_t max_lag = std::min<int64_t>(n - 1, 2048);
  double prev_pair = 1e300;
  double acc = 0.0;
  for (int64_t k = 0; 2 * k + 1 <= max_lag; ++k) {
    double mean_acov0 = 0.0, mean_acov1 = 0.0;
    for (int64_t i = 0; i < m; ++i) {
      mean_acov0 += acov_at(chains + i * n, n, means[i], 2 * k);
      mean_acov1 += acov_at(chains + i * n, n, means[i], 2 * k + 1);
    }
    mean_acov0 /= static_cast<double>(m);
    mean_acov1 /= static_cast<double>(m);
    double rho0 = (2 * k == 0) ? 1.0 : 1.0 - (w - mean_acov0) / var_plus;
    double rho1 = 1.0 - (w - mean_acov1) / var_plus;
    double pair = rho0 + rho1;
    if (pair <= 0.0) break;
    if (pair > prev_pair) pair = prev_pair;
    prev_pair = pair;
    acc += pair;
  }
  double tau = -1.0 + 2.0 * acc;
  if (tau < 1e-12) tau = 1e-12;
  double total = static_cast<double>(m * n);
  double ess = total / tau;
  if (ess > total) ess = total;
  return ess;
}

int ft_abi_version() { return 1; }

}  // extern "C"
