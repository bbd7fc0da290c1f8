"""quemb_tpu_torch: the bootstrap-embedding slice of quemb_tpu on PyTorch.

JAX counterpart: ``quemb_tpu/__init__.py``.  Exports ``BE``,
``fragmentate`` and ``ChemGenArgs``.  Unlike the JAX package this one
switches no x64 mode (every floating-point tensor here carries an explicit
dtype) and keeps no compile cache.

Float32 matrix products run in full float32: the f32 sparse-DF tier is held
to the JAX package's ``Precision.HIGHEST`` kernel, so TF32 is turned off
for CUDA matmuls (``torch.backends.cuda.matmul.allow_tf32 = False``, which
is PyTorch's default as well).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False

from quemb_tpu_torch.api import BE, fragmentate  # noqa: E402
from quemb_tpu_torch.fragment.chemgen import ChemGenArgs  # noqa: E402

__all__ = ["BE", "fragmentate", "ChemGenArgs"]
__version__ = "0.1.0"
