"""Proximal-operator / projection library (capability C3, SURVEY.md §2.1).

Closed-form proxes and projections used by the canonical FASTA problems,
implemented as pure ``jnp`` functions: every one is jittable, vmappable,
complex-safe where meaningful, static-shape, and embarrassingly parallel —
under a sharded mesh each prox applies locally with zero communication
(the prox acts elementwise / rowwise on the signal x).

Numerics match the float64 oracle library
``reference_oracle/generators.py`` (shrink / project_nonneg / project_box /
project_l1_ball / svt) so parity tests can compare trajectories.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "shrink", "prox_l1", "project_nonneg", "project_box",
    "project_l1_ball", "prox_linf", "thin_svd", "svt", "shrink_rows",
    "prox_l21",
    "project_linf_ball", "prox_linear", "prox_zero",
]


def shrink(z, t):
    """Soft threshold  sign(z)·max(|z|−t, 0)  — prox of t·‖·‖₁.

    Complex-safe: shrinks the magnitude, keeps the phase (the oracle's
    formulation: z · max(|z|−t, 0)/max(|z|, ε))."""
    mag = jnp.abs(z)
    scale = jnp.maximum(mag - t, 0.0) / jnp.maximum(mag, 1e-30)
    return z * scale


def prox_l1(z, t, mu=1.0):
    """Prox of  t·μ‖·‖₁  (the LASSO/sparse-logistic g)."""
    return shrink(z, t * mu)


def project_nonneg(z):
    """Projection onto the nonnegative orthant (NNLS indicator prox)."""
    return jnp.maximum(z, 0.0)


def project_box(z, lo, hi):
    """Projection onto the box [lo, hi] (per component)."""
    return jnp.clip(z, lo, hi)


def project_linf_ball(z, radius=1.0):
    """Projection onto {‖z‖∞ ≤ radius}; complex-safe (clips magnitudes,
    keeps phases) — the dual-ball projection of TV denoising."""
    if jnp.issubdtype(jnp.asarray(z).dtype, jnp.complexfloating):
        mag = jnp.abs(z)
        scale = jnp.minimum(mag, radius) / jnp.maximum(mag, 1e-30)
        return z * scale
    return jnp.clip(z, -radius, radius)


def project_l1_ball(z, radius=1.0):
    """Euclidean projection onto {x : ‖x‖₁ ≤ radius} — sort-based
    (Duchi et al.), static-shape and jittable.

    The reference's sort-based algorithm: sort |z| descending, find the
    largest k with u_k·k > (cumsum_k − radius), threshold at
    θ = (cumsum_ρ − radius)/ρ.  Inside-ball inputs pass through unchanged
    (θ clamps to 0 via the where)."""
    z = jnp.asarray(z)
    shape = z.shape
    v = z.ravel()
    mag = jnp.abs(v)
    inside = jnp.sum(mag) <= radius
    u = jnp.sort(mag)[::-1]
    css = jnp.cumsum(u)
    ks = jnp.arange(1, u.size + 1, dtype=u.dtype)
    cond = u * ks > (css - radius)
    # rho = index of the last True (cond is True at k=1 whenever outside)
    idx = jnp.arange(u.size)
    rho_i = jnp.max(jnp.where(cond, idx, -1))
    rho = (rho_i + 1).astype(u.dtype)
    theta = (css[rho_i] - radius) / jnp.maximum(rho, 1.0)
    theta = jnp.where(inside, 0.0, jnp.maximum(theta, 0.0))
    return shrink(v, theta).reshape(shape)


def prox_linf(z, t):
    """Prox of  t·‖·‖∞  via Moreau decomposition:
    prox_{t‖·‖∞}(z) = z − t·P_{‖·‖₁≤1}(z/t)  — used by democratic
    representations (min-max-magnitude problems).

    Degenerate t ≤ 0 (reachable: t = τ·μ and μ is a sweepable leaf, so a
    vmap sweep may include μ=0) returns z — the identity prox of the
    zero function — instead of NaN from the z/t division."""
    safe = z - t * project_l1_ball(z / jnp.maximum(t, 1e-30), 1.0)
    return jnp.where(t > 0, safe, z)


def thin_svd(Z, compute_uv: bool = True):
    """Thin SVD by QR bidiagonalization (LAPACK and cuSOLVER ``gesvd``)
    on every backend.  The GPU's default for matrices up to 1024² is
    Jacobi (``gesvdj``), whose float32 factors reconstruct a 200×200
    matrix to only ~5e-5 relative on an H100 — above matrix completion's
    1e-5 stopping tolerance, so an SVT solve stalls on that floor."""
    return jax.lax.linalg.svd(Z, full_matrices=False, compute_uv=compute_uv,
                              algorithm=jax.lax.linalg.SvdAlgorithm.QR)


def svt(Z, t):
    """Singular-value thresholding — prox of t·‖·‖_* (nuclear norm), for
    matrix-completion problems.  The SVD stays in XLA (``thin_svd``);
    the shrink on σ fuses around it."""
    U, s, Vh = thin_svd(Z)
    s = jnp.maximum(s - t, 0.0)
    # HIGHEST: the reconstruction is a matrix×matrix product, which
    # DEFAULT precision may run in TF32 or bf16 — a silent error on the
    # iterate.
    return jnp.matmul(U * s[..., None, :], Vh,
                      precision=jax.lax.Precision.HIGHEST)


def shrink_rows(Z, t):
    """Row-wise group soft threshold — prox of t·‖·‖_{2,1} (sum of row
    L2 norms), for multiple-measurement-vector (MMV) joint sparsity."""
    norms = jnp.linalg.norm(Z, axis=-1, keepdims=True)
    scale = jnp.maximum(norms - t, 0.0) / jnp.maximum(norms, 1e-30)
    return Z * scale


prox_l21 = shrink_rows


def prox_linear(z, t, c):
    """Prox of the linear functional  g(x) = −Re⟨c, x⟩:  z + t·c.
    (PhaseMax's anchor term.)"""
    return z + t * c


def prox_zero(z, t):
    """Prox of g ≡ 0 (unconstrained smooth minimization)."""
    del t
    return z
