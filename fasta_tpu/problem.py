"""Problem container: one FASTA instance = operator + smooth + prox terms.

The reference expresses a problem as the argument tuple of its solver call
(SURVEY.md §3.2); here a ``Problem`` bundles the same pieces as pytree
objects so the solver, mode-comparison harness, parity tests, sharding
helpers and benchmarks all consume one object — and the whole problem can
be ``device_put`` onto a mesh in one shot.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

import jax.numpy as jnp
import numpy as np

from .operators import LinearOp
from .options import FastaOptions
from .solver import DeviceResult, FastaResult, fasta, make_solver
from .terms import ProxTerm, SmoothTerm

__all__ = ["Problem"]


@dataclass
class Problem:
    """A fully-specified  min f(Ax) + g(x)  instance."""

    name: str
    op: LinearOp
    fterm: SmoothTerm
    gterm: ProxTerm
    x0: Any
    tau0: Optional[float] = None       # explicit stepsize (RNG-parity mode)
    x_true: Optional[np.ndarray] = None
    instance: dict = field(default_factory=dict)   # raw NumPy arrays
    recover: Optional[Callable] = None  # map solver variable -> signal (TV)

    def solve(self, options: Optional[FastaOptions] = None,
              **kwargs) -> FastaResult:
        """Run the jitted solver on this instance (host-side result)."""
        kwargs.setdefault("tau0", self.tau0)
        return fasta(self.op, None, self.fterm, None, self.gterm, None,
                     jnp.asarray(self.x0), options=options, **kwargs)

    def solve_device(self, options: Optional[FastaOptions] = None,
                     tau0: Optional[float] = None) -> DeviceResult:
        """Device-side solve — no host transfers (benchmark path)."""
        opts = options or FastaOptions()
        if tau0 is None:
            tau0 = self.tau0
        if tau0 is None:
            raise ValueError("device path needs an explicit tau0")
        return make_solver(opts)(self.op, self.fterm, self.gterm,
                                 jnp.asarray(self.x0), tau0)

    def with_parts(self, **kwargs) -> "Problem":
        """Copy with replaced fields (used by sharding placement)."""
        return replace(self, **kwargs)

    def recovery_error(self, x, recovered: Optional[bool] = None) -> float:
        """Relative error vs the planted signal (phase-invariant for
        complex problems: aligns the global phase first).

        ``recovered``: pass False for a SOLVER-layout iterate (``recover``
        is applied when present), True for a signal-space vector (e.g.
        the oracle's solution of a planar problem's native complex
        formulation — ``recover`` is skipped).  The default ``None``
        infers from the shape, which is only safe while every
        ``recover`` changes the shape — callers that know which side
        they hold should say so."""
        if self.x_true is None:
            return float("nan")
        x = np.asarray(x)
        xt = np.asarray(self.x_true)
        apply = (self.recover is not None
                 and (recovered is False
                      or (recovered is None and x.shape != xt.shape)))
        if apply:
            x = np.asarray(self.recover(x))
        if np.iscomplexobj(xt) or np.iscomplexobj(x):
            phase = np.vdot(x, xt)
            phase = phase / max(abs(phase), 1e-30)
            x = x * phase
        return float(np.linalg.norm(x - xt) / max(np.linalg.norm(xt), 1e-30))
