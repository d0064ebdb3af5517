"""Site addresses.

The port of ``fugue_tpu/core/address.py``, unchanged: interned, totally
ordered strings with injective escaping (``addr("a#1") != addr("a", 1)``).

Addresses exist only on the host, while a model runs. Once a model is
staged, every site is a fixed slot in a flat position vector, so address
operations never reach the device. Interning via ``sys.intern`` gives O(1)
identity compares.
"""

from __future__ import annotations

import sys
import weakref
from typing import Union

_SEP = "#"
_ESCAPE = "\\"


def _escape_component(s: str) -> str:
    """Injective escaping of a user-supplied name component.

    ``#`` is the structural separator between a base name and an index, so a
    literal ``#`` or ``\\`` inside a component is escaped. This guarantees
    ``addr("a#1") != addr("a", 1)`` (reference: address.rs:174-223).
    """
    if _ESCAPE in s:
        s = s.replace(_ESCAPE, _ESCAPE + _ESCAPE)
    if _SEP in s:
        s = s.replace(_SEP, _ESCAPE + _SEP)
    return s


class Address(str):
    """An interned, totally-ordered site address.

    Subclasses ``str`` so traces can be keyed directly and ordering is
    lexicographic (reference relies on ``BTreeMap<Address, _>`` stable order,
    src/runtime/trace.rs:31-43; we rely on sorted dict keys in the
    ``SiteTable``).
    """

    __slots__ = ("__weakref__",)

    # instance cache: ``sys.intern`` alone does NOT make two Address
    # constructions identical (str.__new__ copies into a fresh instance),
    # so the O(1) identity-compare the docstring promises needs a real
    # cache. Weak values so addresses from long-dead models are collectable
    # (the cache would otherwise grow without bound across many staged
    # models); scoped per-class via ``cls.__dict__`` so a subclass never
    # receives base-class instances (ADVICE r4).
    _instances: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()

    def __new__(cls, value: str) -> "Address":
        v = sys.intern(str(value))
        cache = cls.__dict__.get("_instances")
        if cache is None:
            cache = weakref.WeakValueDictionary()
            setattr(cls, "_instances", cache)
        cached = cache.get(v)
        if cached is None:
            cached = super().__new__(cls, v)
            cache[v] = cached
        return cached

    @property
    def base(self) -> str:
        """The unescaped base name (before the first unescaped separator)."""
        out = []
        i = 0
        while i < len(self):
            c = self[i]
            if c == _ESCAPE and i + 1 < len(self):
                out.append(self[i + 1])
                i += 2
                continue
            if c == _SEP:
                break
            out.append(c)
            i += 1
        return "".join(out)

    def indexed(self, index: Union[int, str]) -> "Address":
        """Append an index component: ``addr(base, i)``."""
        return Address(f"{self}{_SEP}{index}")


def addr(name: str, *indices: Union[int, str]) -> Address:
    """Build an address from a base name and optional indices.

    Mirrors the reference ``addr!`` macro (src/core/address.rs:249-257):
    ``addr("x")`` → ``x``; ``addr("x", 3)`` → ``x#3``; ``addr("x", i, j)`` →
    ``x#i#j``. Name components are escaped injectively.
    """
    parts = [_escape_component(str(name))]
    parts.extend(str(i) for i in indices)
    return Address(_SEP.join(parts))


def scoped_addr(scope: str, name: str, *indices: Union[int, str]) -> Address:
    """Namespaced address: ``scope::name[#i...]``.

    Mirrors ``scoped_addr!`` (reference: src/macros/mod.rs:103-119).
    """
    base = f"{_escape_component(str(scope))}::{_escape_component(str(name))}"
    parts = [base]
    parts.extend(str(i) for i in indices)
    return Address(_SEP.join(parts))
