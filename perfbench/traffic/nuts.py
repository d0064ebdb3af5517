"""NUTS traffic: back-to-back resumed calls of ``nuts_chain`` after set-up and
warmup (``perfbench/sampling.py``, where the cell parameters are listed)."""

from perfbench.sampling import check, setup, trace, window  # noqa: F401
