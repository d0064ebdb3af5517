"""Deterministic per-site seeding.

The port of ``fugue_tpu/core/rng.py``. JAX folds ``crc32(address)`` into a
counter-based key; here each prior draw at a site gets its own
``torch.Generator`` seeded from (run seed, ``address_seed(address)``), so a
site's draw does not depend on the order in which sites run. The two
packages' generators give different numbers from the same seed: tests make
their inputs with numpy and hand them to both.
"""

from __future__ import annotations

import zlib

import torch

_MASK64 = (1 << 64) - 1


def address_seed(address: str) -> int:
    """Stable 31-bit hash of an address (process-independent, unlike
    Python's randomized ``hash``)."""
    return zlib.crc32(str(address).encode("utf-8")) & 0x7FFFFFFF


def _mix(a: int, b: int) -> int:
    """splitmix64 finalizer of ``a`` combined with ``b``: nearby seeds and
    nearby address hashes land far apart."""
    z = (a * 0x9E3779B97F4A7C15 + b + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def site_seed(seed: int, address: str) -> int:
    """Seed of the draw at ``address`` in the run seeded with ``seed``."""
    return _mix(int(seed), address_seed(address))


def site_generator(seed: int, address: str, device) -> torch.Generator:
    """A generator on ``device`` for the draw at ``address``."""
    return torch.Generator(device=device).manual_seed(site_seed(seed, address))
