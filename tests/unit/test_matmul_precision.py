"""Every production matrix product must pin its matmul precision.

Why: at DEFAULT precision an accelerator may run a float32 product in
reduced precision — TF32 on an NVIDIA GPU's tensor cores (~1e-3
relative error), bf16 passes elsewhere — which caps the residual the
solver can reach.  Any matrix×matrix product (planar channels, NMF
factors, MMV breadth, SVT reconstruction) silently degrades unless
precision=HIGHEST is set; HIGHEST keeps full float32 products.

The CPU backend ignores precision, so this cannot be caught numerically
in the suite — instead walk the jaxpr of each production compute path
and assert every dot_general carries a non-default precision.
"""

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from fasta_tpu import operators, prox, terms


def _dot_precisions(closed_jaxpr):
    """Yield the precision param of every dot_general, recursively."""
    todo = [closed_jaxpr.jaxpr]
    while todo:
        jaxpr = todo.pop()
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn.params.get("precision")
            for v in eqn.params.values():
                if isinstance(v, jax.extend.core.ClosedJaxpr):
                    todo.append(v.jaxpr)
                elif isinstance(v, jax.extend.core.Jaxpr):
                    todo.append(v)
                elif isinstance(v, (tuple, list)):
                    for w in v:
                        if isinstance(w, jax.extend.core.ClosedJaxpr):
                            todo.append(w.jaxpr)
                        elif isinstance(w, jax.extend.core.Jaxpr):
                            todo.append(w)


def _assert_all_pinned(fn, *args, expect_dots=True):
    jaxpr = jax.make_jaxpr(fn)(*args)
    precisions = list(_dot_precisions(jaxpr))
    if expect_dots:
        assert precisions, "expected at least one dot_general"
    hi = jax.lax.Precision.HIGHEST
    for p in precisions:
        flat = p if isinstance(p, tuple) else (p,)
        assert all(q == hi for q in flat), \
            f"unpinned dot_general precision {p!r} in {fn}"


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def test_dense_op_matvecs(rng):
    A = jnp.asarray(rng.standard_normal((12, 8)), jnp.float32)
    op = operators.DenseOp(A)
    x = jnp.asarray(rng.standard_normal(8), jnp.float32)
    y = jnp.asarray(rng.standard_normal(12), jnp.float32)
    _assert_all_pinned(op, x)
    _assert_all_pinned(op.rmatvec, y)
    # MMV breadth: matrix rhs is exactly the case DEFAULT precision degrades
    X = jnp.asarray(rng.standard_normal((8, 3)), jnp.float32)
    _assert_all_pinned(op, X)


def test_planar_op_matvecs(rng):
    Ar = jnp.asarray(rng.standard_normal((12, 8)), jnp.float32)
    Ai = jnp.asarray(rng.standard_normal((12, 8)), jnp.float32)
    op = operators.PlanarDenseOp(Ar, Ai)
    x = jnp.asarray(rng.standard_normal((8, 2)), jnp.float32)
    y = jnp.asarray(rng.standard_normal((12, 2)), jnp.float32)
    _assert_all_pinned(op, x)
    _assert_all_pinned(op.rmatvec, y)


def _gradmap(op, term):
    """The solver's unfused gradient map x ↦ Aᴴ∇f(Ax)."""
    return lambda v: op.rmatvec(term.grad(op(v)))


def test_planar_reference_gradmaps(rng):
    Ar = jnp.asarray(rng.standard_normal((12, 8)), jnp.float32)
    Ai = jnp.asarray(rng.standard_normal((12, 8)), jnp.float32)
    op = operators.PlanarDenseOp(Ar, Ai)
    x = jnp.asarray(rng.standard_normal((8, 2)), jnp.float32)
    b2 = jnp.asarray(rng.standard_normal((12, 2)), jnp.float32)
    bm = jnp.abs(jnp.asarray(rng.standard_normal(12), jnp.float32))
    _assert_all_pinned(_gradmap(op, terms.LeastSquares(b2)), x)
    _assert_all_pinned(_gradmap(op, terms.PlanarPhaseHinge(bm)), x)


def test_lstsq_reference_gradmap(rng):
    A = jnp.asarray(rng.standard_normal((12, 8)), jnp.float32)
    x = jnp.asarray(rng.standard_normal(8), jnp.float32)
    b = jnp.asarray(rng.standard_normal(12), jnp.float32)
    _assert_all_pinned(
        lambda v: terms.lstsq_gradmap_reference(A, v, b), x)
    _assert_all_pinned(terms.LeastSquares(b).fused_gradmap(
        operators.DenseOp(A)), x)


def test_nmf_loss(rng):
    Y = jnp.asarray(rng.standard_normal((6, 5)), jnp.float32)
    term = terms.NMFLoss(Y)
    X = jnp.asarray(rng.standard_normal((11, 3)), jnp.float32)
    _assert_all_pinned(term.value, X)
    _assert_all_pinned(term.grad, X)


def test_svt_prox(rng):
    Z = jnp.asarray(rng.standard_normal((6, 5)), jnp.float32)
    _assert_all_pinned(lambda z: prox.svt(z, 0.3), Z)


def test_planar_reference_matches_float64(rng):
    """The pinned-precision planar gradmap must agree with float64
    ground truth (on CPU this is trivially true; the jaxpr checks above
    carry the guarantee to the GPU)."""
    Ar = rng.standard_normal((32, 16)).astype(np.float32)
    Ai = rng.standard_normal((32, 16)).astype(np.float32)
    x = rng.standard_normal((16, 2)).astype(np.float32)
    b = rng.standard_normal((32, 2)).astype(np.float32)
    op = operators.PlanarDenseOp(jnp.asarray(Ar), jnp.asarray(Ai))
    d = op(jnp.asarray(x))
    g = op.rmatvec(terms.LeastSquares(jnp.asarray(b)).grad(d))
    Ar64, Ai64, x64, b64 = (a.astype(np.float64) for a in (Ar, Ai, x, b))
    p, q = Ar64 @ x64, Ai64 @ x64
    d64 = np.stack([p[:, 0] - q[:, 1], p[:, 1] + q[:, 0]], axis=-1)
    r64 = d64 - b64
    pr, qr = Ar64.T @ r64, Ai64.T @ r64
    g64 = np.stack([pr[:, 0] + qr[:, 1], pr[:, 1] - qr[:, 0]], axis=-1)
    np.testing.assert_allclose(np.asarray(d), d64, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(g), g64, rtol=0, atol=1e-3)
