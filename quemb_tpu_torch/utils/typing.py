"""Typed index taxonomy (reference shared/typing.py:64-150).

NewType wrappers documenting which integer space an index lives in; the
array aliases annotate intent (everything is a numpy/jax array at
runtime).  The reference threads these through every signature; here the
hot path works on stacked arrays, so the taxonomy primarily documents
the FragPart contract and the fragment bookkeeping.

JAX counterpart: ``quemb_tpu/utils/typing.py``, of which this is a copy (it
holds no jax).
"""

from __future__ import annotations

from typing import NewType

import numpy as np

#: index into the full AO basis
GlobalAOIdx = NewType("GlobalAOIdx", int)
#: AO index relative to the owning fragment's AO list
RelAOIdx = NewType("RelAOIdx", int)
#: AO index relative to the fragment in which an edge is a center
RelAOIdxInRef = NewType("RelAOIdxInRef", int)
#: molecular-orbital index
MOIdx = NewType("MOIdx", int)
#: shell index into Mole.shells
ShellIdx = NewType("ShellIdx", int)
#: fragment index
FragmentIdx = NewType("FragmentIdx", int)
#: motif (heavy atom) index
MotifIdx = NewType("MotifIdx", int)
#: motif that is a center of its fragment
CenterIdx = NewType("CenterIdx", MotifIdx)
#: motif that is an edge (center of another fragment)
EdgeIdx = NewType("EdgeIdx", MotifIdx)
#: the origin motif a fragment was grown from
OriginIdx = NewType("OriginIdx", CenterIdx)
#: k-point index
KptIdx = NewType("KptIdx", int)

Matrix = np.ndarray
Vector = np.ndarray
Tensor3D = np.ndarray
Tensor4D = np.ndarray
