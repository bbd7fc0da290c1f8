"""Periodic bootstrap embedding (kbe): replacement for the reference
``quemb.kbe`` package (reference kbe/__init__.py:1-4 exports BE and
fragmentate).

JAX counterpart: ``quemb_tpu/kbe/``; this package exports the same names.
"""

from quemb_tpu_torch.kbe.cell import Cell
from quemb_tpu_torch.kbe.df import KGDF, make_etb_aux
from quemb_tpu_torch.kbe.fragment import KFragPart, fragmentate
from quemb_tpu_torch.kbe.pbe import BE
from quemb_tpu_torch.kbe.scf import KRHF

__all__ = ["BE", "Cell", "KGDF", "KRHF", "KFragPart", "fragmentate",
           "make_etb_aux"]
