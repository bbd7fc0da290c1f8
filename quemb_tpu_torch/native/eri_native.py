"""ctypes wrappers of the native (C++/OpenMP) integral engine.

Produces cartesian tensors with identical semantics to the pure-Python
McMurchie-Davidson path in :mod:`quemb_tpu_torch.chem.integrals`; spherical
transforms stay on the Python side.  ``available()`` is true unless the
caller asks for the pure-Python plain versions with
``QUEMB_TPU_NATIVE_ERI=0``; a library that does not build or validate
raises there instead of turning the fast path off.

JAX counterpart: ``quemb_tpu/native/eri_native.py``, of which this is a
copy (it holds no jax).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from quemb_tpu_torch.native import get_lib

_I = ctypes.POINTER(ctypes.c_int)
_D = ctypes.POINTER(ctypes.c_double)
_CONFIGURED = False


def _configure(lib) -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    lib.eri_full_cart.argtypes = [
        ctypes.c_int, _I, _I, _I, _D, _D, _D, _I,
        ctypes.c_int, ctypes.c_double, _D,
    ]
    lib.eri_full_cart.restype = None
    lib.int3c2e_cart.argtypes = [
        ctypes.c_int, _I, _I, _I, _D, _D, _D, _I, ctypes.c_int,
        ctypes.c_int, _I, _I, _I, _D, _D, _D, _I, ctypes.c_int, _D,
    ]
    lib.int3c2e_cart.restype = None
    lib.int2c2e_cart.argtypes = [
        ctypes.c_int, _I, _I, _I, _D, _D, _D, _I, ctypes.c_int, _D,
    ]
    lib.int2c2e_cart.restype = None
    _CONFIGURED = True


def available() -> bool:
    if os.environ.get("QUEMB_TPU_NATIVE_ERI", "1") == "0":
        return False
    _configure(get_lib())
    return True


def _pack(shells):
    """Flatten a Shell list into the C layout (cartesian ao offsets)."""
    n = len(shells)
    l = np.array([sh.l for sh in shells], dtype=np.int32)
    nprim = np.array([len(sh.exps) for sh in shells], dtype=np.int32)
    prim_off = np.zeros(n, dtype=np.int32)
    prim_off[1:] = np.cumsum(nprim)[:-1]
    exps = np.concatenate([sh.exps for sh in shells]).astype(np.float64)
    coefs = np.concatenate([sh.coefs for sh in shells]).astype(np.float64)
    centers = np.ascontiguousarray(
        np.array([sh.center for sh in shells], dtype=np.float64)
    )
    ao_off = np.array([sh.ao_offset for sh in shells], dtype=np.int32)
    return l, nprim, prim_off, exps, coefs, centers, ao_off


def _p(arr, typ):
    return arr.ctypes.data_as(typ)


def eri_full_cart(mol, screen_thresh: float = 1e-14) -> np.ndarray:
    if not available():
        raise RuntimeError("native ERI engine unavailable")
    lib = get_lib()
    args = _pack(mol.shells)
    nao = mol.nao_cart
    out = np.zeros((nao, nao, nao, nao))
    lib.eri_full_cart(
        len(mol.shells), _p(args[0], _I), _p(args[1], _I), _p(args[2], _I),
        _p(args[3], _D), _p(args[4], _D), _p(args[5], _D), _p(args[6], _I),
        nao, screen_thresh, _p(out, _D),
    )
    return out


def int3c2e_cart(mol, mol_aux) -> np.ndarray:
    if not available():
        raise RuntimeError("native ERI engine unavailable")
    lib = get_lib()
    a = _pack(mol.shells)
    b = _pack(mol_aux.shells)
    nao = mol.nao_cart
    naux = getattr(mol_aux, "nao_cart", mol_aux.nao)
    out = np.zeros((nao, nao, naux))
    lib.int3c2e_cart(
        len(mol.shells), _p(a[0], _I), _p(a[1], _I), _p(a[2], _I),
        _p(a[3], _D), _p(a[4], _D), _p(a[5], _D), _p(a[6], _I), nao,
        len(mol_aux.shells), _p(b[0], _I), _p(b[1], _I), _p(b[2], _I),
        _p(b[3], _D), _p(b[4], _D), _p(b[5], _D), _p(b[6], _I), naux,
        _p(out, _D),
    )
    return out


def int2c2e_cart(mol_aux) -> np.ndarray:
    if not available():
        raise RuntimeError("native ERI engine unavailable")
    lib = get_lib()
    b = _pack(mol_aux.shells)
    naux = getattr(mol_aux, "nao_cart", mol_aux.nao)
    out = np.zeros((naux, naux))
    lib.int2c2e_cart(
        len(mol_aux.shells), _p(b[0], _I), _p(b[1], _I), _p(b[2], _I),
        _p(b[3], _D), _p(b[4], _D), _p(b[5], _D), _p(b[6], _I), naux,
        _p(out, _D),
    )
    return out
