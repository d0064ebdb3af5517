"""The ``psystematic_resample`` kernel's share of its roofline in the
traced SMC run, in %: its calls' least time (bytes over the HBM rate,
``perfbench/smc_kernels.py``) over the device time of its two kernels."""

from perfbench.smc_kernels import RESAMPLE, resample_bytes, roofline_share


def read(run):
    return roofline_share(run, RESAMPLE, resample_bytes)
