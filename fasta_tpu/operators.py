"""Linear-operator abstraction (capability C2, SURVEY.md §2.1).

The reference lets ``A`` be a dense matrix, a ``(A(x), At(y))`` closure
pair, or nothing (identity).  Here every operator is a JAX **pytree** whose
leaves are its parameter arrays, so an operator flows through ``jax.jit``,
``shard_map``, ``grad`` and sharding annotations like any other data — the
JAX analog of the reference's duck-typed operator wrapper.

Provided operators:

  * ``DenseOp``       — explicit (possibly complex) matrix; the hot path
                        (GEMV/GEMM; row-shardable over a device mesh)
  * ``IdentityOp``    — default when a problem has no explicit A
  * ``FunctionOp``    — arbitrary (fwd, adj) closure pair (static aux data)
  * ``TVGrad2D`` / ``TVDiv2D`` — 2-D forward-difference stencil and its
                        adjoint, used by total-variation denoising; pure
                        XLA pad/slice compositions (no materialized matrix)
  * ``MaskedFourierOp`` — subsampled FFT measurement operator (phase
                        retrieval style), unitary-scaled
  * ``DiagonalOp``    — elementwise scaling
  * ``ScaledOp``      — scalar · op
  * ``ComposeOp``     — op2 ∘ op1
  * ``StackedOp``     — vertical stack [op1; op2; ...]

All adjoints are *conjugate* transposes so complex problems (phase
retrieval) are handled exactly; ``check_adjoint`` verifies
⟨Ax, y⟩ = ⟨x, Aᴴy⟩ on random vectors, the reference's built-in fixture
(arXiv:1501.04979 §5).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "LinearOp", "DenseOp", "IdentityOp", "FunctionOp", "TVGrad2D",
    "TVDiv2D", "MaskedFourierOp", "DiagonalOp", "ScaledOp", "ComposeOp",
    "StackedOp", "PlanarDenseOp", "LowPrecDenseOp", "SparseOp",
    "as_linear_op", "check_adjoint", "AdjointOp",
]


class LinearOp:
    """Abstract linear operator: ``y = op(x)``, adjoint ``op.H(y)``."""

    def __call__(self, x):
        raise NotImplementedError

    def rmatvec(self, y):
        """Apply the conjugate-transpose (adjoint) operator."""
        raise NotImplementedError

    @property
    def H(self) -> "LinearOp":
        """The adjoint as a first-class operator."""
        return AdjointOp(self)

    # pytree plumbing shared by parameter-free operators
    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux, children
        return cls()


@jax.tree_util.register_pytree_node_class
class AdjointOp(LinearOp):
    def __init__(self, base: LinearOp):
        self.base = base

    def __call__(self, x):
        return self.base.rmatvec(x)

    def rmatvec(self, y):
        return self.base(y)

    @property
    def H(self):
        return self.base

    def tree_flatten(self):
        return (self.base,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class DenseOp(LinearOp):
    """Explicit dense matrix A ∈ 𝔽^{m×n}; matvec/rmatvec are XLA dots.

    The matrix is stored once; row-sharding it over a mesh axis makes the
    forward matvec local and the adjoint matvec an XLA ``psum`` — the
    data-parallel layout of SURVEY.md §2.3.

    Matmuls run at ``Precision.HIGHEST`` by default: a lower precision
    lets the accelerator round f32 inputs to TF32 or bf16 (~1e-3..1e-2
    relative error), which directly caps the residual the solver can
    reach — and GEMV is bandwidth-bound, so full f32 costs nothing.
    Pass ``precision=None`` (or any ``jax.lax.Precision``) to override
    for compute-bound matrix×matrix workloads.
    """

    def __init__(self, A, precision=jax.lax.Precision.HIGHEST):
        self.A = A
        self.precision = precision

    def __call__(self, x):
        return jnp.matmul(self.A, x, precision=self.precision)

    def rmatvec(self, y):
        return jnp.matmul(self.A.conj().T, y, precision=self.precision)

    @property
    def shape(self):
        return self.A.shape

    def tree_flatten(self):
        return (self.A,), (self.precision,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)


@jax.tree_util.register_pytree_node_class
class SparseOp(LinearOp):
    """Sparse operator backed by ``jax.experimental.sparse.BCOO`` — the
    JAX answer to the reference's scipy.sparse support.  Accepts
    a scipy sparse matrix via :meth:`from_scipy` (``as_linear_op``
    dispatches automatically)."""

    def __init__(self, M):
        self.M = M                         # BCOO

    @classmethod
    def from_scipy(cls, sp_matrix, dtype=None):
        from jax.experimental import sparse as jsparse
        if dtype is not None:
            sp_matrix = sp_matrix.astype(np.dtype(dtype))
        return cls(jsparse.BCOO.from_scipy_sparse(sp_matrix))

    def __call__(self, x):
        return self.M @ x

    def rmatvec(self, y):
        Mt = self.M.T
        if jnp.issubdtype(self.M.dtype, jnp.complexfloating):
            return (Mt @ jnp.conj(y)).conj()
        return Mt @ y

    @property
    def shape(self):
        return self.M.shape

    def tree_flatten(self):
        return (self.M,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class LowPrecDenseOp(LinearOp):
    """Dense operator with LOW-PRECISION STORAGE (bf16 by default) and
    f32 accumulation — the mixed-precision fast path.

    GEMV is HBM-bandwidth-bound, so halving the stored matrix bytes
    halves the wall time per matvec pass.  The gradient then carries
    ~bf16 relative error (~1e-2..1e-3), which caps the reachable
    residual — the intended workflow is iterative refinement: solve fast
    at low precision, then warm-restart the full-precision operator from
    the result (fasta_tpu.checkpoint.resume), which converges in a few
    final iterations.  Outputs are always f32.
    """

    def __init__(self, A):
        self.A = A                       # already in storage dtype

    @classmethod
    def from_dense(cls, A, storage_dtype=jnp.bfloat16):
        return cls(jnp.asarray(A, storage_dtype))

    def __call__(self, x):
        return jax.lax.dot_general(
            self.A, x.astype(self.A.dtype),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)

    def rmatvec(self, y):
        return jax.lax.dot_general(
            self.A, y.astype(self.A.dtype),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)

    @property
    def shape(self):
        return self.A.shape

    def tree_flatten(self):
        return (self.A,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class PlanarDenseOp(LinearOp):
    """Complex dense operator in PLANAR layout: an all-real
    representation of a complex matrix, for backends without a complex
    type.  ``DenseOp`` over a complex64 matrix is the native form.

    The matrix is stored as two real arrays (Ar, Ai); vectors carry
    real/imag as a trailing channel axis: x ∈ ℝ^{n×2} ↦ d ∈ ℝ^{m×2} with

        d = [Ar xr − Ai xi,  Ar xi + Ai xr]        (complex product)
        Aᴴ y = [Arᵀyr + Aiᵀyi,  Arᵀyi − Aiᵀyr]      (conjugate adjoint)

    Each application is two real (m,n)×(n,2) matmuls.  Crucially the
    solver's complex-safe inner products Re⟨u,v⟩ equal the plain real
    dot of the planar vectors, so the identical all-real solver drives
    complex problems bit-for-bit (SURVEY.md §3.4 / §7 hard part 6).
    Leading axes stay (m, n), so row-sharding works unchanged.
    """

    def __init__(self, Ar, Ai, precision=jax.lax.Precision.HIGHEST):
        self.Ar = Ar
        self.Ai = Ai
        self.precision = precision

    @classmethod
    def from_complex(cls, A, dtype=jnp.float32, **kw):
        A = np.asarray(A)
        return cls(jnp.asarray(A.real, dtype), jnp.asarray(A.imag, dtype),
                   **kw)

    def __call__(self, x):
        p = jnp.matmul(self.Ar, x, precision=self.precision)   # (m, 2)
        q = jnp.matmul(self.Ai, x, precision=self.precision)
        return jnp.stack([p[:, 0] - q[:, 1], p[:, 1] + q[:, 0]], axis=-1)

    def rmatvec(self, y):
        p = jnp.matmul(self.Ar.T, y, precision=self.precision)  # (n, 2)
        q = jnp.matmul(self.Ai.T, y, precision=self.precision)
        return jnp.stack([p[:, 0] + q[:, 1], p[:, 1] - q[:, 0]], axis=-1)

    @property
    def shape(self):
        return self.Ar.shape

    def tree_flatten(self):
        return (self.Ar, self.Ai), (self.precision,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, precision=aux[0])


@jax.tree_util.register_pytree_node_class
class IdentityOp(LinearOp):
    def __call__(self, x):
        return x

    def rmatvec(self, y):
        return y


@jax.tree_util.register_pytree_node_class
class FunctionOp(LinearOp):
    """Arbitrary (forward, adjoint) closure pair — the reference's
    function-operator mode.  The callables are static (trace-time) aux
    data; any arrays they close over are baked into the jit trace."""

    def __init__(self, fwd: Callable, adj: Callable):
        self.fwd = fwd
        self.adj = adj

    def __call__(self, x):
        return self.fwd(x)

    def rmatvec(self, y):
        return self.adj(y)

    def tree_flatten(self):
        return (), (self.fwd, self.adj)

    @classmethod
    def tree_unflatten(cls, aux, children):
        del children
        return cls(*aux)


@jax.tree_util.register_pytree_node_class
class TVGrad2D(LinearOp):
    """2-D discrete gradient (forward differences, Neumann boundary).

    (H, W) → (2, H, W): channel 0 vertical diffs, channel 1 horizontal;
    last row/col of each channel zero.  Matches the oracle stencil
    ``reference_oracle.generators.tv_grad_2d`` exactly.  Pure XLA
    pad/slice — fuses into the surrounding elementwise graph.
    """

    def __call__(self, x):
        dv = jnp.concatenate([x[1:, :] - x[:-1, :],
                              jnp.zeros((1, x.shape[1]), x.dtype)], axis=0)
        dh = jnp.concatenate([x[:, 1:] - x[:, :-1],
                              jnp.zeros((x.shape[0], 1), x.dtype)], axis=1)
        return jnp.stack([dv, dh])

    def rmatvec(self, p):
        return TVDiv2D()(p)


@jax.tree_util.register_pytree_node_class
class TVDiv2D(LinearOp):
    """Adjoint of ``TVGrad2D``: (2, H, W) → (H, W)  (equals −divergence).

    Matches ``reference_oracle.generators.tv_div_2d``.
    """

    def __call__(self, p):
        pv, ph = p[0], p[1]
        zrow = jnp.zeros((1, pv.shape[1]), p.dtype)
        zcol = jnp.zeros((ph.shape[0], 1), p.dtype)
        # adjoint of vertical forward difference
        out = (jnp.concatenate([zrow, pv[:-1, :]], axis=0)
               - jnp.concatenate([pv[:-1, :], zrow], axis=0))
        # adjoint of horizontal forward difference
        out = out + (jnp.concatenate([zcol, ph[:, :-1]], axis=1)
                     - jnp.concatenate([ph[:, :-1], zcol], axis=1))
        return out

    def rmatvec(self, y):
        return TVGrad2D()(y)


@jax.tree_util.register_pytree_node_class
class MaskedFourierOp(LinearOp):
    """Subsampled unitary FFT: ``y = mask ⊙ FFT(x)/√n`` on the flat signal.

    ``mask`` is a {0,1} (or complex modulation) array of the same length as
    the signal.  Adjoint is exact: ``x = IFFT(mask* ⊙ y)·√n / n · n`` — we
    use the unitary normalization so the adjoint is the conjugate map.
    Coded-diffraction phase retrieval uses a stack of these via StackedOp.
    """

    def __init__(self, mask):
        self.mask = mask

    def __call__(self, x):
        return self.mask * jnp.fft.fft(x, norm="ortho")

    def rmatvec(self, y):
        return jnp.fft.ifft(jnp.conj(self.mask) * y, norm="ortho")

    def tree_flatten(self):
        return (self.mask,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class DiagonalOp(LinearOp):
    def __init__(self, d):
        self.d = d

    def __call__(self, x):
        return self.d * x

    def rmatvec(self, y):
        return jnp.conj(self.d) * y

    def tree_flatten(self):
        return (self.d,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class ScaledOp(LinearOp):
    """c · op with real scalar c (kept real so adjoint is c · opᴴ)."""

    def __init__(self, c: float, op: LinearOp):
        self.c = c
        self.op = op

    def __call__(self, x):
        return self.c * self.op(x)

    def rmatvec(self, y):
        return self.c * self.op.rmatvec(y)

    def tree_flatten(self):
        return (self.op,), (self.c,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], children[0])


@jax.tree_util.register_pytree_node_class
class ComposeOp(LinearOp):
    """outer ∘ inner:  x ↦ outer(inner(x))."""

    def __init__(self, outer: LinearOp, inner: LinearOp):
        self.outer = outer
        self.inner = inner

    def __call__(self, x):
        return self.outer(self.inner(x))

    def rmatvec(self, y):
        return self.inner.rmatvec(self.outer.rmatvec(y))

    def tree_flatten(self):
        return (self.outer, self.inner), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class StackedOp(LinearOp):
    """Vertical stack: x ↦ [op₁x; op₂x; …] along a new leading axis.

    All member outputs must share a shape; the adjoint sums the member
    adjoints.  Used e.g. for coded-diffraction phase retrieval (stack of
    masked FFTs).
    """

    def __init__(self, ops: Sequence[LinearOp]):
        self.ops = tuple(ops)

    def __call__(self, x):
        return jnp.stack([op(x) for op in self.ops])

    def rmatvec(self, y):
        out = self.ops[0].rmatvec(y[0])
        for i, op in enumerate(self.ops[1:], start=1):
            out = out + op.rmatvec(y[i])
        return out

    def tree_flatten(self):
        return self.ops, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children)


def as_linear_op(A: Any, At: Any = None) -> LinearOp:
    """Normalize the reference's accepted operator forms into a LinearOp:
    ndarray → DenseOp, None → IdentityOp, callable pair → FunctionOp,
    LinearOp → itself.  (Reference capability: matrix OR function pair OR
    implicit identity; SURVEY.md §2.1 C2.)
    """
    if A is None:
        return IdentityOp()
    if isinstance(A, LinearOp):
        return A
    if isinstance(A, (np.ndarray, jax.Array)):
        return DenseOp(jnp.asarray(A))
    try:
        import scipy.sparse as _sp
        if _sp.issparse(A):
            return SparseOp.from_scipy(A)
    except ImportError:                    # pragma: no cover
        pass
    if callable(getattr(A, "matvec", None)) \
            and callable(getattr(A, "rmatvec", None)) \
            and hasattr(A, "shape"):
        # (checked before the bare-callable branch: scipy's
        # LinearOperator defines __call__ too)
        # scipy.sparse.linalg.LinearOperator-style object (SURVEY.md L1:
        # the reference accepts these).  scipy's methods are host-side
        # NumPy and cannot trace, so route each application through
        # jax.pure_callback — the jitted solver works unchanged, paying
        # one host round trip per matvec.  A COMPATIBILITY path: for hot
        # loops convert to DenseOp / SparseOp / a jax-native FunctionOp.
        m, n = A.shape

        def mv(x):
            return jax.pure_callback(
                lambda v: np.asarray(A.matvec(np.asarray(v)),
                                     dtype=v.dtype),
                jax.ShapeDtypeStruct((m,), jnp.asarray(x).dtype), x,
                vmap_method="sequential")

        def rmv(y):
            return jax.pure_callback(
                lambda v: np.asarray(A.rmatvec(np.asarray(v)),
                                     dtype=v.dtype),
                jax.ShapeDtypeStruct((n,), jnp.asarray(y).dtype), y,
                vmap_method="sequential")

        return FunctionOp(mv, rmv)
    if callable(A):
        if not callable(At):
            raise ValueError("A is a callable; At must be its adjoint callable")
        return FunctionOp(A, At)
    raise TypeError(f"unsupported operator type: {type(A)}")


def check_adjoint(op: LinearOp, x_like, key, rtol: float = 1e-4,
                  n_trials: int = 2) -> float:
    """Verify ⟨Ax, y⟩ = ⟨x, Aᴴy⟩ on random vectors (the reference's
    built-in adjoint fixture, arXiv:1501.04979 §5).  Returns the max
    relative error; raises if it exceeds ``rtol`` (loose default: fp32)."""
    x_like = jnp.asarray(x_like)
    d_like = jax.eval_shape(op, x_like)
    worst = 0.0
    for t in range(n_trials):
        key, k1, k2 = jax.random.split(key, 3)
        x = _randn_like(k1, x_like.shape, x_like.dtype)
        y = _randn_like(k2, d_like.shape, d_like.dtype)
        lhs = jnp.vdot(y, op(x))
        rhs = jnp.vdot(op.rmatvec(y), x)
        scale = max(abs(complex(lhs)), abs(complex(rhs)), 1e-30)
        err = abs(complex(lhs) - complex(rhs)) / scale
        worst = max(worst, err)
    if worst > rtol:
        raise ValueError(f"adjoint check failed: rel err {worst:.3e} > {rtol:.1e}")
    return worst


def _randn_like(key, shape, dtype):
    if jnp.issubdtype(dtype, jnp.complexfloating):
        k1, k2 = jax.random.split(key)
        return (jax.random.normal(k1, shape).astype(dtype)
                + 1j * jax.random.normal(k2, shape).astype(dtype))
    return jax.random.normal(key, shape, dtype)
