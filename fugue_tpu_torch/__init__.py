"""fugue_tpu_torch: the PyTorch/CUDA port of fugue_tpu.

Five engines run end to end on one device over the model language of the
JAX package: its 24 distributions, with discrete sites and the bounded,
simplex and dependent-bound transforms, and the ``masked``, ``cond``,
``plate`` and ``Model`` combinators. Vectorized HMC and NUTS: the
trace/handler runtime, staging into a potential on
unconstrained R^d, batched forces through ``torch.func``, the HMC drive and
the lock-step NUTS tree build with dual averaging and diagonal or dense
mass adaptation, ``resume``, the incremental ``HmcSession`` and
``NutsSession``, split-R-hat, rank-normalized R-hat, Geweke and ESS
diagnostics, and the Gaussian-plate likelihood kernel in CUDA
(``ops.kernels.pnormal_loglik_sum``). Adaptive SMC: a batched prior draw,
the ESS-driven β ladder, single-site MH or HMC rejuvenation, and the
log-sum-exp and systematic-resampling kernels in CUDA
(``ops.kernels.plogsumexp``, ``ops.kernels.psystematic_resample``).
ChEES-HMC: one trajectory length for all chains, learned from the chain
batch, with ``CheesSession``. Adaptive single-site MH over a chain batch
(``adaptive_mcmc_chain``). Mean-field and full-rank VI with optax's Adam
and SGD rules (``optimize_meanfield_vi``, ``optimize_fullrank_vi``), ABC
rejection and ABC-SMC (``abc_rejection``, ``abc_smc_weighted``,
``abc_smc``), predictive sampling (``predictive``), and the replay, score,
safe, strict and reconciling handlers. The other engines: MAP and the
Laplace approximation (``map_estimate``, ``laplace_approximation``), exact
marginalization of enumerable discrete sites (``marginalize``),
HMC-within-Gibbs (``gibbs_chain``), elliptical slice sampling
(``ess_chain``), parallel tempering (``pt_chain``), WAIC and PSIS-LOO
(``pointwise_log_likelihood``, ``waic``, ``psis_loo``), the conjugate
validation harness, simulation-based calibration (``sbc``) and
trans-dimensional MH (``adaptive_mcmc_chain_dynamic``); and the bf16
design-matrix products of ``ops.linalg`` (``matmul_bf16x2_fastgrad``).
Entry points run on the card (``device="cuda"``) unless the caller names
another device. Module paths and public names mirror ``fugue_tpu``. The
package imports no JAX.
"""

__version__ = "0.1.0"

from .errors import (
    ErrorCategory,
    ErrorCode,
    FugueError,
    ModelStructureError,
    StagingError,
    TraceAccessError,
    TypeMismatchError,
    ValidationError,
)
from .core.address import Address, addr, scoped_addr
from .core.numerics import (
    log1p_exp,
    log_gamma,
    log_sum_exp,
    normalize_log_probs,
    safe_log,
    weighted_log_sum_exp,
)
from .core.distributions import (
    ALL_DISTRIBUTIONS,
    Bernoulli,
    BernoulliLogits,
    Beta,
    Binomial,
    Categorical,
    Cauchy,
    ChiSquared,
    Dirichlet,
    MultivariateNormal,
    DiscreteUniform,
    Distribution,
    EXTRA_DISTRIBUTIONS,
    Exponential,
    Gamma,
    Geometric,
    HalfCauchy,
    HalfNormal,
    InverseGamma,
    NegativeBinomial,
    Laplace,
    LogNormal,
    Normal,
    Poisson,
    StudentT,
    Support,
    Uniform,
    Weibull,
)
from .core.model import (
    Model,
    cond,
    factor,
    guard,
    masked,
    observe,
    plate,
    pure,
    sample,
    sequence_vec,
    traverse_vec,
)
from .core.rng import address_seed
from .core import transforms
from .inference.abc import (
    ABCError,
    ABCResult,
    ABCSMCConfig,
    SummaryStatsDistance,
    abc_rejection,
    abc_scalar_summary,
    abc_smc,
    abc_smc_weighted,
    euclidean_distance,
    manhattan_distance,
)
from .inference.chees import ChEESConfig, ChEESResult, CheesSession, chees_chain
from .inference.ess import ESSConfig, ESSResult, ess_chain
from .inference.gibbs import GibbsResult, gibbs_chain
from .inference.map_laplace import (
    LaplaceResult,
    MAPConfig,
    MAPResult,
    laplace_approximation,
    map_estimate,
)
from .inference.marginalize import MarginalizedModel, marginalize
from .inference.mh_dynamic import DynamicMHResult, adaptive_mcmc_chain_dynamic
from .inference.model_comparison import (
    ELPDResult,
    compare,
    pointwise_log_likelihood,
    psis_loo,
    waic,
)
from .inference.sbc import SBCResult, sbc
from .inference.tempering import PTConfig, PTResult, geometric_ladder, pt_chain
from .inference.validation import (
    ConjugateBetaBernoulliConfig,
    ConjugateNormalConfig,
    ValidationResult,
    ks_two_sample,
    validate_beta_bernoulli,
    validate_conjugate_normal,
)
from .inference.diagnostics import ParameterSummary, print_diagnostics, summarize_samples
from .inference.hmc import HMCConfig, HMCResult, HmcSession, hmc_chain, hmc_transition
from .inference.mcmc_utils import (
    ess,
    ess_multichain,
    geweke,
    r_hat,
    rank_normalized_split_r_hat,
    split_r_hat,
)
from .inference.mh import MHResult, adaptive_mcmc_chain
from .inference.nuts import NUTSConfig, NUTSResult, NutsSession, nuts_chain, nuts_transition
from .inference.predictive import posterior_predictive, predictive
from .inference.smc import SMCConfig, SMCResult, adaptive_smc, importance_reweight
from .ops.kernels import pnormal_loglik_sum
from .inference.vi import (
    FullRankGuide,
    GuideError,
    MeanFieldGuide,
    VIConfig,
    VIResult,
    elbo,
    estimate_elbo,
    optimize_fullrank_vi,
    optimize_meanfield_vi,
)
from .runtime.handler import Handler, run
from .runtime.interpreters import (
    PredictiveHandler,
    PriorHandler,
    ReconcileReport,
    ReconcilingScoreGivenTrace,
    ReplayHandler,
    SafeReplayHandler,
    SafeScoreGivenTrace,
    ScoreGivenTrace,
    StrictScoreGivenTrace,
    ValuesHandler,
    score_given_trace,
    score_given_trace_reconciled,
    score_given_trace_safe,
    score_given_trace_strict,
)
from .runtime.staging import StagedModel, stage
from .runtime.trace import Choice, Trace
