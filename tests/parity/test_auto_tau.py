"""C8 auto-τ₀ parity (VERDICT r1 item 7 / SURVEY.md §7 hard part 5).

The Lipschitz estimator draws two random points; oracle (NumPy RNG) and
JAX solver (jax.random) could never agree, so every parity test used an
explicit τ₀.  Both now accept caller-supplied estimation points
(``est_points``): generate the pair once in NumPy float64, feed both,
and the auto-τ₀ trajectories must coincide like any fixed-τ₀ run.

Oracle block: reference_oracle/fasta_numpy.py (C8 section); JAX side:
fasta_tpu/solver.py estimate_stepsize(points=...).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import problems as P
from reference_oracle.fasta_numpy import fasta as fasta_np

# Same reduced-size instances as tests/parity/test_parity.py.
CASES = {
    "lasso": (dict(m=150, n=300, k=15), dict(tol=1e-9, max_iters=200)),
    "nnls": (dict(m=120, n=60), dict(tol=1e-9, max_iters=200)),
    "logistic": (dict(m=150, n=80), dict(tol=1e-8, max_iters=150)),
    "tv": (dict(h=32, w=32), dict(tol=1e-8, max_iters=120)),
    "phase_retrieval": (dict(m=256, n=16), dict(tol=1e-8, max_iters=150)),
    "phase_retrieval_cdp": (dict(n=32, K=4), dict(tol=1e-8, max_iters=120)),
    "democratic": (dict(m=64, n=256), dict(tol=1e-8, max_iters=120)),
    "mmv": (dict(m=80, n=160, l=4, k=10), dict(tol=1e-8, max_iters=150)),
    "matrix_completion": (dict(d1=30, d2=30, rank=2),
                          dict(tol=1e-7, max_iters=80)),
    "max_norm": (dict(d1=40, d2=8), dict(tol=1e-9, max_iters=80)),
    "svm": (dict(m=120, n=30), dict(tol=1e-8, max_iters=150)),
    "sparse_lasso": (dict(m=200, n=400, density=0.05, k=15),
                     dict(tol=1e-9, max_iters=200)),
    "nmf": (dict(d1=30, d2=20, rank=3), dict(tol=1e-8, max_iters=150)),
}


def _dtype_for(name):
    if name in ("phase_retrieval", "phase_retrieval_cdp"):
        return jnp.complex128
    return jnp.float64


def _est_points(x0, seed=1234):
    rng = np.random.default_rng(seed)
    def draw():
        z = rng.standard_normal(np.shape(x0))
        if np.iscomplexobj(x0):
            z = z + 1j * rng.standard_normal(np.shape(x0))
        return z.astype(np.asarray(x0).dtype)
    return draw(), draw()


@pytest.mark.parametrize("name", list(CASES))
def test_auto_tau0_parity(name):
    kwargs, skw = CASES[name]
    prob = P.build(name, dtype=_dtype_for(name), **kwargs)
    inst = prob.instance
    pts = _est_points(inst["x0"])

    r_np = fasta_np(inst["op"], inst.get("op_t"), inst["f"], inst["gradf"],
                    inst["g"], inst["proxg"], inst["x0"],
                    tau0=None, est_points=pts, **skw)
    prob.tau0 = None
    r_j = prob.solve(tau0=None, est_points=pts, **skw)

    # The estimated L and τ₀ must agree to f64 roundoff …
    assert r_np.initial_tau == pytest.approx(r_j.initial_tau, rel=1e-12)
    assert r_np.L_estimate == pytest.approx(r_j.L_estimate, rel=1e-12)
    # … and the resulting trajectories like any fixed-τ₀ parity run.
    k = min(10, r_np.iteration_count, r_j.iteration_count)
    np.testing.assert_allclose(r_j.taus[:k], r_np.taus[:k], rtol=1e-7,
                               err_msg=f"{name}: auto-tau0 trajectory")
    np.testing.assert_allclose(r_j.fvals[:k], r_np.fvals[:k], rtol=1e-7)
