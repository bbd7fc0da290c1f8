"""Minimal insertion-ordered set used by the fragmentation bookkeeping.

JAX counterpart: ``quemb_tpu/utils/ordered_set.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator


class OSet:
    """Insertion-ordered set with the handful of ops fragmentation needs."""

    __slots__ = ("_d",)

    def __init__(self, items: Iterable = ()):  # noqa: D107
        self._d = dict.fromkeys(items)

    def add(self, x) -> None:
        self._d[x] = None

    def __contains__(self, x) -> bool:
        return x in self._d

    def __iter__(self) -> Iterator:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __getitem__(self, i: int):
        if isinstance(i, slice):
            return list(self._d)[i]
        return list(self._d)[i]

    def __repr__(self) -> str:
        return f"OSet({list(self._d)})"

    def __eq__(self, other) -> bool:
        if isinstance(other, OSet):
            return list(self._d) == list(other._d)
        return list(self._d) == list(other)

    def union(self, *others: Iterable) -> "OSet":
        out = OSet(self)
        for o in others:
            for x in o:
                out.add(x)
        return out

    __or__ = union

    def __and__(self, other) -> "OSet":
        other = set(other)
        return OSet(x for x in self if x in other)

    def difference(self, other) -> "OSet":
        other = set(other)
        return OSet(x for x in self if x not in other)

    __sub__ = difference

    def issubset(self, other) -> bool:
        other = set(other)
        return all(x in other for x in self)

    def copy(self) -> "OSet":
        return OSet(self)

    def to_list(self) -> list:
        return list(self._d)


def union_of_seqs(*seqs: Iterable) -> OSet:
    out = OSet()
    for s in seqs:
        for x in s:
            out.add(x)
    return out
