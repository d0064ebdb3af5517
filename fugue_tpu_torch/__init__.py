"""fugue_tpu_torch: the PyTorch/CUDA port of fugue_tpu.

Two engines run end to end on one device. Vectorized HMC: the model
language, the trace/handler runtime, staging into a potential on
unconstrained R^d, batched forces through ``torch.func``, the HMC drive
with dual averaging and diagonal mass adaptation, split-R-hat/ESS
diagnostics, and the Gaussian-plate likelihood kernel in CUDA
(``ops.kernels.pnormal_loglik_sum``). Adaptive SMC: a batched prior draw,
the ESS-driven β ladder, single-site MH or HMC rejuvenation, and the
log-sum-exp and systematic-resampling kernels in CUDA
(``ops.kernels.plogsumexp``, ``ops.kernels.psystematic_resample``).
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
from .core.distributions import Distribution, LogNormal, Normal
from .core.model import factor, guard, observe, sample
from .inference.diagnostics import print_diagnostics, summarize_samples
from .inference.hmc import HMCConfig, HMCResult, hmc_chain, hmc_transition
from .inference.smc import SMCConfig, SMCResult, adaptive_smc, importance_reweight
from .ops.kernels import pnormal_loglik_sum
from .runtime.handler import Handler, run
from .runtime.staging import StagedModel, stage
