"""Objective terms as pytrees: smooth f(A·) and prox-friendly g(·).

Design point: the reference passes f/gradf/g/proxg as bare
closures; here each term is a **registered pytree** whose leaves are its
data arrays (measurement vector b, anchor vectors, masks…).  The solver
takes terms as jit *arguments*, so

  * data is never baked into the trace as constants — a new instance with
    the same shapes reuses the compiled executable;
  * every array can be explicitly placed on a ``jax.sharding.Mesh``
    (row-sharded b next to row-sharded A), which closure constants cannot
    guarantee (fasta_tpu/sharding.py);
  * terms compose: ``fasta()`` wraps raw callables in Function* terms for
    reference-style calls.

Smooth terms implement ``value(d) -> scalar`` and ``grad(d) -> array``
(evaluated at d = A x); prox terms implement ``value(x) -> scalar`` and
``prox(z, t) -> array``.  Term semantics match the reference example
suite (SURVEY.md §2.2) and the oracle generators.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from . import prox as _prox

__all__ = [
    "SmoothTerm", "LeastSquares", "Logistic", "PhaseHinge", "NMFLoss",
    "FunctionSmooth", "ProxTerm", "L1Norm", "NonnegIndicator",
    "BoxIndicator", "LinfBallIndicator", "LinearAnchor", "NuclearNorm",
    "L21Norm", "LinfNorm", "MaxRowNormBall", "ZeroTerm", "FunctionProx",
    "as_smooth_term", "as_prox_term", "MaskedLogistic", "SquaredHinge",
    "L2Norm2", "PlanarPhaseHinge", "PlanarLinearAnchor",
]


# --------------------------------------------------------------------------
# Smooth terms  f(d), ∇f(d)  — measurement-space data as leaves.
# --------------------------------------------------------------------------

class SmoothTerm:
    # True when ∇f is affine in d (quadratic f): enables the solver's
    # zero-matvec FISTA extrapolation of the gradient map.
    grad_affine = False

    def value(self, d):
        raise NotImplementedError

    def value_dd(self, d):
        """f(d) as a double-word (hi, lo) pair — used by the solver's
        high-precision float32 path (fasta_tpu/precision.py) so the
        nonmonotone-window comparisons resolve differences far below
        float32 ulp.  Default: exact lift of the plain value (no extra
        precision); terms whose value is a large reduction override
        this with a compensated reduction."""
        from .precision import dd
        return dd(self.value(d))

    def value_parts(self, d):
        """Elementwise double-word contributions of f(d): ``(hi, lo)``
        1-D arrays whose dd-sum equals :meth:`value_dd`, or None when
        the term cannot decompose its value elementwise.  Lets the
        solver fuse the f-reduction with the backtracking/BB dot
        products into one variadic ``lax.reduce``
        (precision.reduce_dd_many) — one kernel dispatch per iteration
        instead of three on the latency-bound hot loop."""
        del d
        return None

    def grad(self, d):
        raise NotImplementedError

    def fused_gradmap(self, op):
        """Optional fused evaluation  x ↦ (d, f(d), Aᴴ∇f(d))  in one
        operator pass.  Return None when no fusion applies (the solver
        then uses the lazy two-call path)."""
        del op
        return None

    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux, children
        return cls()


@jax.tree_util.register_pytree_node_class
class LeastSquares(SmoothTerm):
    """f(d) = ½‖d − b‖²  (complex-safe Hermitian norm)."""

    grad_affine = True

    def __init__(self, b):
        self.b = b

    def value(self, d):
        r = d - self.b
        return 0.5 * jnp.real(jnp.vdot(r, r))

    def value_dd(self, d):
        from . import precision as _p
        return _p.dd_scale(_p.norm2_dd(d - self.b), 0.5)

    def value_parts(self, d):
        from . import precision as _p
        p, e = _p.dot_parts(d - self.b, d - self.b)
        # exact: scaling a binary float by 0.5 never rounds
        return 0.5 * p, 0.5 * e

    def grad(self, d):
        return d - self.b

    def fused_gradmap(self, op):
        """One-pass (Ax, ½‖Ax−b‖², Aᴴ(Ax−b)): a row-sharded shard_map
        region with a single psum when the operator is mesh-sharded, the
        plain XLA graph for a single-device real dense matrix or the TV
        stencil.  The FISTA path extrapolates the returned gradient
        affinely (``grad_affine``), so a fused map saves one matvec per
        accelerated iteration."""
        from .operators import DenseOp, ScaledOp, TVDiv2D
        from .sharding import (GridShardedDenseOp,
                               GridShardedPlanarDenseOp,
                               GridShardedSparseOp,
                               RowShardedDenseOp, RowShardedTVDivOp,
                               sharded_lstsq_gradmap,
                               sharded_lstsq_gradmap_2d,
                               sharded_planar_lstsq_gradmap_2d,
                               sharded_sparse_lstsq_gradmap_2d,
                               sharded_tv_lstsq_gradmap)
        if isinstance(op, RowShardedDenseOp):
            return sharded_lstsq_gradmap(op, self.b)
        if isinstance(op, GridShardedDenseOp):
            return sharded_lstsq_gradmap_2d(op, self.b)
        if isinstance(op, GridShardedSparseOp):
            return sharded_sparse_lstsq_gradmap_2d(op, self.b)
        if isinstance(op, GridShardedPlanarDenseOp):
            return sharded_planar_lstsq_gradmap_2d(op, self.b)
        if isinstance(op, RowShardedTVDivOp):
            return sharded_tv_lstsq_gradmap(op, self.b)
        if (isinstance(op, ScaledOp) and isinstance(op.op, TVDiv2D)
                and jnp.asarray(self.b).ndim == 2):
            mu = float(op.c)
            return lambda p: tv_gradmap_reference(p, self.b, mu)
        if not isinstance(op, DenseOp):
            return None
        A = op.A
        if A.ndim != 2 or jnp.issubdtype(A.dtype, jnp.complexfloating) \
                or jnp.asarray(self.b).ndim != 1:
            return None
        return lambda x: lstsq_gradmap_reference(A, x, self.b)

    def tree_flatten(self):
        return (self.b,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


def lstsq_gradmap_reference(A, x, b):
    """Two-pass (d, f, g) = (Ax, ½‖Ax−b‖², Aᴴ(Ax−b)) for a dense matrix:
    the same matvecs as the unfused solver, with f as a shape-preserving
    elementwise-product sum rather than ``LeastSquares.value``'s
    ``jnp.vdot`` (the parity tests hold the two equal).  Products are
    pinned to HIGHEST like ``DenseOp``'s: full float32, never TF32 or
    bf16 passes, the moment x grows a batch axis."""
    hi = jax.lax.Precision.HIGHEST
    d = jnp.matmul(A, x, precision=hi)
    r = d - b
    f = 0.5 * jnp.sum(jnp.real(r * jnp.conj(r)))
    g = jnp.matmul(A.conj().T, r, precision=hi)
    return d, f, g


def tv_gradmap_reference(p, b, mu):
    """(μ·div p, ½‖μ·div p − b‖², μ·grad(μ·div p − b)) for the TV dual
    field p (2,H,W) and image b (H,W) — the oracle's stencils."""
    from .operators import ScaledOp, TVDiv2D, TVGrad2D
    d = ScaledOp(mu, TVDiv2D())(p)
    r = d - b
    f = 0.5 * jnp.vdot(r, r).real
    g = mu * TVGrad2D()(r)
    return d, f, g


@jax.tree_util.register_pytree_node_class
class Logistic(SmoothTerm):
    """Logistic loss  Σ log(1+exp(d)) − bᵀd,  labels b ∈ {0,1}; stable
    evaluation matches the oracle (max(d,0) + log1p(exp(−|d|)))."""

    def __init__(self, b):
        self.b = b

    def value(self, d):
        return jnp.sum(jnp.maximum(d, 0.0)
                       + jnp.log1p(jnp.exp(-jnp.abs(d))) - self.b * d)

    def value_dd(self, d):
        from . import precision as _p
        ell = (jnp.maximum(d, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(d)))
               - self.b * d)
        return _p.sum_dd(ell)

    def value_parts(self, d):
        ell = (jnp.maximum(d, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(d)))
               - self.b * d)
        ell = jnp.ravel(ell)
        return ell, jnp.zeros_like(ell)

    def grad(self, d):
        return 1.0 / (1.0 + jnp.exp(-d)) - self.b

    def fused_gradmap(self, op):
        from .sharding import (RowShardedDenseOp,
                               sharded_pointwise_gradmap)
        if isinstance(op, RowShardedDenseOp):
            return sharded_pointwise_gradmap(op, _sum_of(_logistic_elem),
                                             self.b)
        return None

    def tree_flatten(self):
        return (self.b,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


def _logistic_elem(d, b):
    """Elementwise (ℓ, ℓ′) of the stable logistic loss for the sharded
    fused gradmap."""
    ell = (jnp.maximum(d, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(d))) - b * d)
    return ell, 1.0 / (1.0 + jnp.exp(-d)) - b


def _hinge_elem(d, y):
    """Elementwise (ℓ, ℓ′) of the squared hinge (labels ±1)."""
    r = jnp.maximum(0.0, 1.0 - y * d)
    return 0.5 * r * r, -y * r


def _sum_of(loss_elem):
    """Adapt an elementwise (ℓ, ℓ′) loss to the sharded gradmap's
    (Σℓ, ℓ′) contract."""
    def loss_local(d, *data):
        ell, dl = loss_elem(d, *data)
        return jnp.sum(ell), dl
    return loss_local


@jax.tree_util.register_pytree_node_class
class MaskedLogistic(SmoothTerm):
    """Masked logistic loss for 1-bit matrix completion:
    f(D) = Σ_{(i,j)∈Ω} log(1+exp(D_ij)) − Y_ij·D_ij  with Y ∈ {0,1} on
    the observed set Ω (mask ∈ {0,1})."""

    def __init__(self, Y, mask):
        self.Y = Y
        self.mask = mask

    def value(self, d):
        loss = jnp.maximum(d, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(d))) \
            - self.Y * d
        return jnp.sum(self.mask * loss)

    def value_dd(self, d):
        from . import precision as _p
        loss = jnp.maximum(d, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(d))) \
            - self.Y * d
        return _p.sum_dd(self.mask * loss)

    def value_parts(self, d):
        from . import precision as _p
        loss = jnp.maximum(d, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(d))) \
            - self.Y * d
        return _p.sum_parts(self.mask * loss)

    def grad(self, d):
        return self.mask * (1.0 / (1.0 + jnp.exp(-d)) - self.Y)

    def tree_flatten(self):
        return (self.Y, self.mask), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class PhaseHinge(SmoothTerm):
    """Smooth circular hinge for PhaseMax phase retrieval:
    f(d) = ½ Σ max(|d|−b, 0)², Wirtinger gradient max(|d|−b,0)·d/|d|."""

    def __init__(self, b):
        self.b = b

    def value(self, d):
        r = jnp.maximum(jnp.abs(d) - self.b, 0.0)
        return 0.5 * jnp.sum(r * r)

    def value_dd(self, d):
        from . import precision as _p
        r = jnp.maximum(jnp.abs(d) - self.b, 0.0)
        return _p.dd_scale(_p.norm2_dd(r), 0.5)

    def value_parts(self, d):
        from . import precision as _p
        r = jnp.maximum(jnp.abs(d) - self.b, 0.0)   # real even for d ∈ ℂ
        p, e = _p.dot_parts(r, r)
        # exact: scaling a binary float by 0.5 never rounds
        return 0.5 * p, 0.5 * e

    def grad(self, d):
        mag = jnp.abs(d)
        r = jnp.maximum(mag - self.b, 0.0)
        return (r / jnp.maximum(mag, 1e-30)) * d

    def fused_gradmap(self, op):
        from .sharding import (RowShardedDenseOp, ShardedCDPOp,
                               sharded_cdp_phase_hinge_gradmap,
                               sharded_phase_hinge_gradmap)
        if isinstance(op, RowShardedDenseOp):
            return sharded_phase_hinge_gradmap(op, self.b)
        if isinstance(op, ShardedCDPOp):
            return sharded_cdp_phase_hinge_gradmap(op, self.b)
        return None

    def tree_flatten(self):
        return (self.b,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class PlanarPhaseHinge(SmoothTerm):
    """PhaseMax hinge on PLANAR complex measurements d ∈ ℝ^{m×2}
    (see operators.PlanarDenseOp):  |d| = √(dr²+di²) computed on real
    channels; gradient is the Wirtinger gradient mapped to planar —
    identical math to PhaseHinge on ℂ, all-real execution."""

    def __init__(self, b):
        self.b = b                      # (m,) real magnitudes

    def value(self, d):
        mag = jnp.sqrt(jnp.sum(d * d, axis=-1))
        r = jnp.maximum(mag - self.b, 0.0)
        return 0.5 * jnp.sum(r * r)

    def value_dd(self, d):
        from . import precision as _p
        mag = jnp.sqrt(jnp.sum(d * d, axis=-1))
        r = jnp.maximum(mag - self.b, 0.0)
        return _p.dd_scale(_p.norm2_dd(r), 0.5)

    def value_parts(self, d):
        from . import precision as _p
        mag = jnp.sqrt(jnp.sum(d * d, axis=-1))
        r = jnp.maximum(mag - self.b, 0.0)
        p, e = _p.dot_parts(r, r)
        return 0.5 * p, 0.5 * e

    def grad(self, d):
        mag = jnp.sqrt(jnp.sum(d * d, axis=-1))
        r = jnp.maximum(mag - self.b, 0.0)
        return (r / jnp.maximum(mag, 1e-30))[:, None] * d

    def fused_gradmap(self, op):
        from .sharding import (GridShardedPlanarDenseOp,
                               RowShardedPlanarDenseOp,
                               sharded_planar_phase_hinge_gradmap,
                               sharded_planar_phase_hinge_gradmap_2d)
        if isinstance(op, RowShardedPlanarDenseOp):
            return sharded_planar_phase_hinge_gradmap(op, self.b)
        if isinstance(op, GridShardedPlanarDenseOp):
            return sharded_planar_phase_hinge_gradmap_2d(op, self.b)
        return None

    def tree_flatten(self):
        return (self.b,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class SquaredHinge(SmoothTerm):
    """SVM squared hinge:  f(d) = ½ Σ max(0, 1 − y⊙d)²,
    ∇f(d) = −y⊙max(0, 1 − y⊙d);  labels y ∈ {−1, +1}."""

    def __init__(self, y):
        self.y = y

    def value(self, d):
        r = jnp.maximum(0.0, 1.0 - self.y * d)
        return 0.5 * jnp.sum(r * r)

    def value_dd(self, d):
        from . import precision as _p
        r = jnp.maximum(0.0, 1.0 - self.y * d)
        return _p.dd_scale(_p.norm2_dd(r), 0.5)

    def value_parts(self, d):
        from . import precision as _p
        r = jnp.maximum(0.0, 1.0 - self.y * d)
        p, e = _p.dot_parts(r, r)
        return 0.5 * p, 0.5 * e

    def grad(self, d):
        r = jnp.maximum(0.0, 1.0 - self.y * d)
        return -self.y * r

    def fused_gradmap(self, op):
        from .sharding import (RowShardedDenseOp,
                               sharded_pointwise_gradmap)
        if isinstance(op, RowShardedDenseOp):
            return sharded_pointwise_gradmap(op, _sum_of(_hinge_elem),
                                             self.y)
        return None

    def tree_flatten(self):
        return (self.y,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class NMFLoss(SmoothTerm):
    """Joint nonnegative-matrix-factorization loss on the STACKED factor
    variable X = [W; H] ∈ ℝ^{(d1+d2)×r} (identity operator):

        f(X) = ½‖W Hᵀ − Y‖²_F ,
        ∇f   = [R H; Rᵀ W],  R = W Hᵀ − Y.

    The [P1] paper's remaining FBS application (SURVEY.md §2.2 note):
    f is smooth but nonconvex — FBS iterates are well-defined and the
    oracle (reference_oracle/generators.py make_nmf) runs the identical
    math, so parity is per-iteration trajectory parity."""

    def __init__(self, Y):
        self.Y = Y

    @property
    def _d1(self):
        return self.Y.shape[0]

    def _residual(self, X):
        # DEFAULT precision lets an accelerator run a float32
        # matrix×matrix product in TF32 or bf16 passes (~1e-3 relative
        # error) — pin HIGHEST like the operator classes do.
        W, H = X[:self._d1], X[self._d1:]
        return jnp.matmul(W, H.T, precision=jax.lax.Precision.HIGHEST) - self.Y

    def value(self, X):
        R = self._residual(X)
        return 0.5 * jnp.sum(R * R)

    def value_dd(self, X):
        from . import precision as _p
        return _p.dd_scale(_p.norm2_dd(self._residual(X)), 0.5)

    def value_parts(self, X):
        from . import precision as _p
        R = self._residual(X)
        p, e = _p.dot_parts(R, R)
        return 0.5 * p, 0.5 * e

    def grad(self, X):
        hi = jax.lax.Precision.HIGHEST
        W, H = X[:self._d1], X[self._d1:]
        R = jnp.matmul(W, H.T, precision=hi) - self.Y
        return jnp.concatenate([jnp.matmul(R, H, precision=hi),
                                jnp.matmul(R.T, W, precision=hi)], axis=0)

    def tree_flatten(self):
        return (self.Y,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class FunctionSmooth(SmoothTerm):
    """Wrap raw (f, gradf) callables — reference-style closures.  The
    callables are static aux data (arrays they capture are baked into the
    trace; prefer the data-carrying terms above for sharded runs).

    ``gradf=None`` derives the gradient by autodiff (``jax.grad``) — a
    capability the reference cannot offer: any differentiable f works
    without a hand-written gradient.  For complex measurement spaces the
    conjugate Wirtinger convention of FBS is applied (∂f/∂conj(d))."""

    def __init__(self, f: Callable, gradf: Optional[Callable] = None):
        self.f = f
        if gradf is None:
            raw = jax.grad(lambda d: jnp.real(f(d)))

            def gradf(d):
                out = raw(d)
                if jnp.issubdtype(jnp.asarray(d).dtype,
                                  jnp.complexfloating):
                    return jnp.conj(out)
                return out
        self.gradf = gradf

    def value(self, d):
        return self.f(d)

    def grad(self, d):
        return self.gradf(d)

    def tree_flatten(self):
        return (), (self.f, self.gradf)

    @classmethod
    def tree_unflatten(cls, aux, children):
        del children
        return cls(*aux)


# --------------------------------------------------------------------------
# Prox terms  g(x), prox_{t·g}(z)  — signal-space data as leaves.
# --------------------------------------------------------------------------

class ProxTerm:
    def value(self, x):
        raise NotImplementedError

    def prox(self, z, t):
        raise NotImplementedError

    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux, children
        return cls()


@jax.tree_util.register_pytree_node_class
class L1Norm(ProxTerm):
    """g = μ‖·‖₁; prox = soft threshold (shrink).

    μ is a pytree LEAF (data, not static config): a batch of μ values can
    be vmapped for single-compile hyperparameter sweeps (solver.py
    make_batch_solver)."""

    def __init__(self, mu=1.0):
        self.mu = mu

    def value(self, x):
        return self.mu * jnp.sum(jnp.abs(x))

    def prox(self, z, t):
        return _prox.shrink(z, t * self.mu)

    def tree_flatten(self):
        return (self.mu,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class LinfNorm(ProxTerm):
    """g = μ‖·‖∞; prox via Moreau/L1-ball projection (democratic
    representations)."""

    def __init__(self, mu: float = 1.0):
        self.mu = mu

    def value(self, x):
        return self.mu * jnp.max(jnp.abs(x))

    def prox(self, z, t):
        return _prox.prox_linf(z, t * self.mu)

    def tree_flatten(self):
        return (self.mu,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class L21Norm(ProxTerm):
    """g = μ‖·‖_{2,1} (sum of row norms); prox = row-wise group shrink
    (MMV joint sparsity)."""

    def __init__(self, mu: float = 1.0):
        self.mu = mu

    def value(self, X):
        return self.mu * jnp.sum(jnp.linalg.norm(X, axis=-1))

    def prox(self, Z, t):
        return _prox.shrink_rows(Z, t * self.mu)

    def tree_flatten(self):
        return (self.mu,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class NuclearNorm(ProxTerm):
    """g = μ‖·‖_* ; prox = singular-value thresholding (matrix
    completion).  The SVD stays in XLA (SURVEY.md §2.4)."""

    def __init__(self, mu: float = 1.0):
        self.mu = mu

    def value(self, X):
        return self.mu * jnp.sum(_prox.thin_svd(X, compute_uv=False))

    def prox(self, Z, t):
        return _prox.svt(Z, t * self.mu)

    def tree_flatten(self):
        return (self.mu,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class NonnegIndicator(ProxTerm):
    """g = indicator{x ≥ 0}; prox = orthant projection (NNLS)."""

    def value(self, x):
        return jnp.zeros((), jnp.asarray(x).real.dtype)

    def prox(self, z, t):
        del t
        return _prox.project_nonneg(z)


@jax.tree_util.register_pytree_node_class
class BoxIndicator(ProxTerm):
    """g = indicator{lo ≤ x ≤ hi}; prox = clamp (TV dual ball, real)."""

    def __init__(self, lo: float = -1.0, hi: float = 1.0):
        self.lo = lo
        self.hi = hi

    def value(self, x):
        return jnp.zeros((), jnp.asarray(x).real.dtype)

    def prox(self, z, t):
        del t
        return _prox.project_box(z, self.lo, self.hi)

    def tree_flatten(self):
        return (), (self.lo, self.hi)

    @classmethod
    def tree_unflatten(cls, aux, children):
        del children
        return cls(*aux)


@jax.tree_util.register_pytree_node_class
class LinfBallIndicator(ProxTerm):
    """g = indicator{‖x‖∞ ≤ r}; complex-safe magnitude clip."""

    def __init__(self, radius: float = 1.0):
        self.radius = radius

    def value(self, x):
        return jnp.zeros((), jnp.asarray(x).real.dtype)

    def prox(self, z, t):
        del t
        return _prox.project_linf_ball(z, self.radius)

    def tree_flatten(self):
        return (), (self.radius,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        del children
        return cls(aux[0])


@jax.tree_util.register_pytree_node_class
class MaxRowNormBall(ProxTerm):
    """g = indicator{max_i ‖row_i‖₂ ≤ r} — the max-norm factorization
    constraint; prox scales each row onto the L2 ball."""

    def __init__(self, radius: float = 1.0):
        self.radius = radius

    def value(self, X):
        return jnp.zeros((), jnp.asarray(X).real.dtype)

    def prox(self, Z, t):
        del t
        norms = jnp.linalg.norm(Z, axis=-1, keepdims=True)
        scale = jnp.minimum(norms, self.radius) / jnp.maximum(norms, 1e-30)
        return Z * scale

    def tree_flatten(self):
        return (), (self.radius,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        del children
        return cls(aux[0])


@jax.tree_util.register_pytree_node_class
class LinearAnchor(ProxTerm):
    """g(x) = −Re⟨c, x⟩ (PhaseMax anchor); prox(z,t) = z + t·c."""

    def __init__(self, c):
        self.c = c

    def value(self, x):
        return -jnp.real(jnp.vdot(self.c, x))

    def prox(self, z, t):
        return z + t * self.c

    def tree_flatten(self):
        return (self.c,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class L2Norm2(ProxTerm):
    """g = (λ/2)‖·‖² (ridge/Tikhonov); prox(z,t) = z/(1+tλ)."""

    def __init__(self, lam=1.0):
        self.lam = lam

    def value(self, x):
        return 0.5 * self.lam * jnp.real(jnp.vdot(x, x))

    def prox(self, z, t):
        return z / (1.0 + t * self.lam)

    def tree_flatten(self):
        return (self.lam,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class PlanarLinearAnchor(ProxTerm):
    """g(x) = −⟨c, x⟩ on planar vectors (≡ −Re⟨c,x⟩ on ℂ);
    prox(z,t) = z + t·c.  c ∈ ℝ^{n×2}."""

    def __init__(self, c):
        self.c = c

    def value(self, x):
        return -jnp.vdot(self.c, x).real

    def prox(self, z, t):
        return z + t * self.c

    def tree_flatten(self):
        return (self.c,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class ZeroTerm(ProxTerm):
    """g ≡ 0 (smooth-only minimization)."""

    def value(self, x):
        return jnp.zeros((), jnp.asarray(x).real.dtype)

    def prox(self, z, t):
        del t
        return z


@jax.tree_util.register_pytree_node_class
class FunctionProx(ProxTerm):
    """Wrap raw (g, proxg) callables — reference-style closures."""

    def __init__(self, g: Callable, proxg: Callable):
        self.g = g
        self.proxg = proxg

    def value(self, x):
        if self.g is None:
            return jnp.zeros((), jnp.asarray(x).real.dtype)
        return self.g(x)

    def prox(self, z, t):
        return self.proxg(z, t)

    def tree_flatten(self):
        return (), (self.g, self.proxg)

    @classmethod
    def tree_unflatten(cls, aux, children):
        del children
        return cls(*aux)


def as_smooth_term(f, gradf=None) -> SmoothTerm:
    if isinstance(f, SmoothTerm):
        return f
    return FunctionSmooth(f, gradf)


def as_prox_term(g, proxg=None) -> ProxTerm:
    if isinstance(g, ProxTerm):
        return g
    if g is None and proxg is None:
        return ZeroTerm()
    return FunctionProx(g, proxg)
