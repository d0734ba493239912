"""Unit tests: every prox/projection vs its closed form and the oracle
NumPy implementations (SURVEY.md §4 test strategy)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fasta_tpu import prox
from reference_oracle import generators as G

RNG = np.random.default_rng(42)


def test_shrink_matches_closed_form():
    z = RNG.standard_normal(1000)
    t = 0.3
    expect = np.sign(z) * np.maximum(np.abs(z) - t, 0.0)
    np.testing.assert_allclose(prox.shrink(jnp.asarray(z), t), expect,
                               atol=1e-12)


def test_shrink_complex_keeps_phase():
    z = RNG.standard_normal(500) + 1j * RNG.standard_normal(500)
    t = 0.5
    out = np.asarray(prox.shrink(jnp.asarray(z), t))
    mag = np.abs(z)
    nz = mag > t
    np.testing.assert_allclose(np.abs(out[nz]), mag[nz] - t, atol=1e-12)
    # phases preserved where nonzero
    np.testing.assert_allclose(np.angle(out[nz]), np.angle(z[nz]),
                               atol=1e-12)
    assert np.all(out[~nz] == 0)


def test_shrink_matches_oracle():
    z = RNG.standard_normal(333)
    np.testing.assert_allclose(prox.shrink(jnp.asarray(z), 0.17),
                               G.shrink(z, 0.17), atol=1e-14)


def test_project_nonneg_and_box():
    z = RNG.standard_normal(100)
    np.testing.assert_array_equal(prox.project_nonneg(jnp.asarray(z)),
                                  np.maximum(z, 0))
    np.testing.assert_array_equal(prox.project_box(jnp.asarray(z), -0.5, 0.2),
                                  np.clip(z, -0.5, 0.2))


@pytest.mark.parametrize("scale", [0.1, 1.0, 10.0])
def test_project_l1_ball_matches_oracle(scale):
    z = RNG.standard_normal(200) * scale
    out = np.asarray(prox.project_l1_ball(jnp.asarray(z), 1.0))
    expect = G.project_l1_ball(z, 1.0)
    np.testing.assert_allclose(out, expect, atol=1e-12)
    assert np.abs(out).sum() <= 1.0 + 1e-9


def test_project_l1_ball_inside_is_identity():
    z = RNG.standard_normal(50)
    z = z / (np.abs(z).sum() * 2)          # well inside the ball
    np.testing.assert_allclose(prox.project_l1_ball(jnp.asarray(z), 1.0), z,
                               atol=1e-14)


def test_prox_linf_moreau_identity():
    """prox_{t‖·‖∞}(z) + t·P_{L1}(z/t) must equal z (Moreau)."""
    z = RNG.standard_normal(120)
    t = 0.7
    p = np.asarray(prox.prox_linf(jnp.asarray(z), t))
    q = t * np.asarray(prox.project_l1_ball(jnp.asarray(z) / t, 1.0))
    np.testing.assert_allclose(p + q, z, atol=1e-12)
    np.testing.assert_allclose(p, G.prox_linf(z, t), atol=1e-12)


def test_svt_matches_oracle():
    Z = RNG.standard_normal((40, 30))
    out = np.asarray(prox.svt(jnp.asarray(Z), 0.9))
    expect = G.svt(Z, 0.9)
    np.testing.assert_allclose(out, expect, atol=1e-9)
    # thresholded singular values
    s = np.linalg.svd(out, compute_uv=False)
    s0 = np.linalg.svd(Z, compute_uv=False)
    np.testing.assert_allclose(s, np.maximum(s0 - 0.9, 0.0), atol=1e-9)


@pytest.mark.parametrize("shape", [(40, 30), (30, 40)])
def test_thin_svd_is_the_thin_factorization(shape):
    """Thin factors (wide and tall), singular values alone without U, V."""
    Z = RNG.standard_normal(shape)
    U, s, Vh = (np.asarray(a) for a in prox.thin_svd(jnp.asarray(Z)))
    k = min(shape)
    assert U.shape == (shape[0], k) and Vh.shape == (k, shape[1])
    np.testing.assert_allclose((U * s) @ Vh, Z, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(prox.thin_svd(jnp.asarray(Z), compute_uv=False)),
        np.linalg.svd(Z, compute_uv=False), atol=1e-12)


def test_thin_svd_lowers_to_qr_gesvd():
    """The QR route (gesvd), not the backend's default SVD."""
    import jax
    text = jax.jit(prox.thin_svd).lower(
        jnp.ones((8, 8), jnp.float32)).as_text()
    assert "gesvd" in text and "gesdd" not in text


def test_shrink_rows_matches_oracle():
    Z = RNG.standard_normal((60, 7))
    np.testing.assert_allclose(prox.shrink_rows(jnp.asarray(Z), 0.4),
                               G.shrink_rows(Z, 0.4), atol=1e-12)


def test_project_linf_ball_complex():
    z = RNG.standard_normal(80) + 1j * RNG.standard_normal(80)
    out = np.asarray(prox.project_linf_ball(jnp.asarray(z), 0.8))
    assert np.all(np.abs(out) <= 0.8 + 1e-12)
    small = np.abs(z) <= 0.8
    np.testing.assert_allclose(out[small], z[small], atol=1e-14)


def test_max_row_norm_projection():
    Z = RNG.standard_normal((30, 6)) * 3
    from fasta_tpu.terms import MaxRowNormBall
    out = np.asarray(MaxRowNormBall(1.0).prox(jnp.asarray(Z), 0.1))
    norms = np.linalg.norm(out, axis=-1)
    assert np.all(norms <= 1.0 + 1e-9)
    np.testing.assert_allclose(out, G.project_max_row_norm(Z, 1.0),
                               atol=1e-12)


def test_prox_is_firmly_nonexpansive_shrink():
    """‖prox(a)−prox(b)‖ ≤ ‖a−b‖ — sanity property on random pairs."""
    a = RNG.standard_normal(100)
    b = RNG.standard_normal(100)
    pa = np.asarray(prox.shrink(jnp.asarray(a), 0.5))
    pb = np.asarray(prox.shrink(jnp.asarray(b), 0.5))
    assert np.linalg.norm(pa - pb) <= np.linalg.norm(a - b) + 1e-12


def test_prox_linf_degenerate_threshold():
    """t = 0 (reachable via a mu=0 sweep leaf) must be the identity
    prox, not NaN from the internal z/t (ADVICE r1)."""
    import jax.numpy as jnp
    from fasta_tpu import prox as jprox
    from reference_oracle import generators as oracle

    z = np.array([3.0, -1.5, 0.2, 0.0])
    out = np.asarray(jprox.prox_linf(jnp.asarray(z), 0.0))
    np.testing.assert_array_equal(out, z)
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(oracle.prox_linf(z, 0.0), z)
    # and a vmap sweep including 0 stays finite
    import jax
    ts = jnp.asarray([0.0, 0.5, 2.0])
    outs = jax.vmap(lambda t: jprox.prox_linf(jnp.asarray(z), t))(ts)
    assert bool(jnp.all(jnp.isfinite(outs)))
