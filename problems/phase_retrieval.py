"""E5 — Phase retrieval (PhaseMax-style):  recover x from b = |Ax|.

The flagship sharded configuration (BASELINE.json config 5): complex
Gaussian A with 16 384 measurement rows.  PhaseMax relaxation solved as
FBS on the penalized form

    min  ½ Σ max(|(Ax)_i| − b_i, 0)²  −  δ·Re⟨x̂₀, x⟩

with the smooth circular hinge as f and a linear-shift prox for g.  All
solver inner products take real parts, so the identical engine drives
this complex problem (SURVEY.md §3.4).  Row-sharding A over the mesh
turns the adjoint matvec into a psum — see fasta_tpu/sharding.py.
"""

from __future__ import annotations

import jax.numpy as jnp

import numpy as np

from fasta_tpu import (DenseOp, LinearAnchor, PhaseHinge, PlanarDenseOp,
                       PlanarLinearAnchor, PlanarPhaseHinge)
from fasta_tpu.problem import Problem
from reference_oracle.generators import make_phase_retrieval

from . import register

__all__ = ["build"]


def _planar(z, dtype):
    """ℂ^n → ℝ^{n×2} (real/imag channels last)."""
    z = np.asarray(z)
    return jnp.asarray(np.stack([z.real, z.imag], axis=-1), dtype)


@register("phase_retrieval")
def build(m: int = 16384, n: int = 256, delta: float = 0.1, seed: int = 5,
          dtype=jnp.complex64, planar: bool = False) -> Problem:
    """Set ``planar=True`` for the all-real planar-complex formulation
    (dtype then gives the REAL dtype, e.g. float32); the default is the
    native complex ``DenseOp``."""
    inst = make_phase_retrieval(m=m, n=n, delta=delta, seed=seed)
    if planar:
        rdt = np.zeros((), dtype).real.dtype   # accept f32 or c64 spec
        c = delta * inst["x0_hat"]
        return Problem(
            name=f"phase_retrieval_planar[{m}x{n}]",
            op=PlanarDenseOp.from_complex(inst["A"], rdt),
            fterm=PlanarPhaseHinge(jnp.asarray(inst["b"], rdt)),
            gterm=PlanarLinearAnchor(_planar(c, rdt)),
            x0=_planar(inst["x0"], rdt),
            x_true=inst["x_true"],
            instance=inst,
            recover=lambda xp: np.asarray(xp)[..., 0]
            + 1j * np.asarray(xp)[..., 1],
        )
    rdt = np.zeros((), dtype).real.dtype
    return Problem(
        name=f"phase_retrieval[{m}x{n}]",
        op=DenseOp(jnp.asarray(inst["A"], dtype)),
        fterm=PhaseHinge(jnp.asarray(inst["b"], rdt)),
        gterm=LinearAnchor(jnp.asarray(delta * inst["x0_hat"], dtype)),
        x0=jnp.asarray(inst["x0"], dtype),
        x_true=inst["x_true"],
        instance=inst,
    )


if __name__ == "__main__":
    from fasta_tpu.harness import compare_modes, format_comparison
    problem = build()
    print(format_comparison(problem, compare_modes(problem, tol=1e-6,
                                                   max_iters=1000)))
