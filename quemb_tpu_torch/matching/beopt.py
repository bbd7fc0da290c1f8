"""BE optimization harness (reference molbe/opt.py:BEOPT).

JAX counterpart: ``quemb_tpu/matching/beopt.py``.  The objective is the
port's ``be_func``, which runs on the device of the fragments' ERIs; the
quasi-Newton loop around it is host numpy.
"""

from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass, field

import numpy as np

from quemb_tpu_torch.embed.fragment import Fragment
from quemb_tpu_torch.matching.optqn import FrankQN
from quemb_tpu_torch.solvers.dispatch import be_func

logger = logging.getLogger(__name__)


@dataclass
class BEOPT:
    pot: list[float]
    fragments: list[Fragment]
    Nocc: int
    enuc: float
    solver: str = "CCSD"
    only_chem: bool = False
    use_cumulant: bool = True
    max_space: int = 500
    conv_tol: float = 1.0e-6
    relax_density: bool = False
    ebe_hf: float = 0.0

    iter: int = 0
    err: float = 0.0
    Ebe: tuple = field(default_factory=lambda: (0.0, [0.0, 0.0, 0.0]))

    def objfunc(self, xk) -> np.ndarray:
        err_, errvec_, ebe_ = be_func(
            list(xk),
            self.fragments,
            self.Nocc,
            self.solver,
            only_chem=self.only_chem,
            relax_density=self.relax_density,
            use_cumulant=self.use_cumulant,
            eeval=True,
            return_vec=True,
        )
        self.err = err_
        self.Ebe = ebe_
        return errvec_

    def optimize(self, method="QN", J0=None, trust_region=False) -> None:
        if method != "QN":
            raise ValueError(f"Unsupported optimization method {method}")
        logger.info(
            f"Starting BE optimization, solver={self.solver}, "
            f"only_chem={self.only_chem}"
        )
        f0 = self.objfunc(np.asarray(self.pot))
        logger.info(f"Initial density-matching error: {self.err:.4e}")
        optQN = FrankQN(
            self.objfunc, np.asarray(self.pot), f0, J0,
            max_space=self.max_space,
        )
        if self.err < self.conv_tol:
            logger.info("CONVERGED w/o optimization steps")
            return
        for _ in range(self.max_space):
            optQN.next_step(self.iter, trust_region_opt=trust_region)
            self.iter += 1
            logger.info(
                f"iter {self.iter}: density-matching error {self.err:.4e}"
            )
            if self.err < self.conv_tol:
                logger.info("CONVERGED")
                return
        warnings.warn(f"BE did not converge in {self.max_space} steps")
