"""Problem-instance generators shared by the oracle and the JAX build.

Every instance is generated in float64 NumPy with an explicit seed, so the
oracle (reference_oracle/fasta_numpy.py) and the JAX solver consume the
*identical* data — RNG parity by construction (SURVEY.md §7 hard part 5).

The five required problems ([N: BASELINE.json:6-12]):
  E1 LASSO          min ½‖Ax−b‖² + μ‖x‖₁          dense Gaussian 1000×2000
  E2 NNLS           min ½‖Ax−b‖²  s.t. x ≥ 0
  E3 sparse logistic min Σ log(1+exp(Ax)) − bᵀAx + μ‖x‖₁
  E4 TV denoising   min ½‖x−b‖² + μ·TV(x)          512×512, stencil operator
  E5 phase retrieval PhaseMax-style hinge relaxation, complex A, 16k rows

Each ``make_*`` returns a dict with the raw instance arrays plus NumPy
callables (f, gradf, g, proxg, A, At) ready for the oracle.  The JAX build
re-derives its callables from the same arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "shrink", "project_nonneg", "project_box", "project_l1_ball", "svt",
    "prox_linf", "shrink_rows", "project_max_row_norm",
    "make_lasso", "make_nnls", "make_logistic", "make_tv",
    "make_phase_retrieval", "make_phase_retrieval_cdp", "make_democratic",
    "make_mmv", "make_matrix_completion", "make_max_norm", "make_svm",
    "make_sparse_lasso", "make_nmf",
    "tv_grad_2d", "tv_div_2d",
]


# --------------------------------------------------------------------------
# NumPy prox library (C3) — closed forms used by the oracle problems.
# --------------------------------------------------------------------------

def shrink(z: np.ndarray, t: float) -> np.ndarray:
    """Soft threshold: sign(z)·max(|z|−t, 0); complex-safe (phase kept)."""
    mag = np.abs(z)
    scale = np.maximum(mag - t, 0.0) / np.maximum(mag, 1e-30)
    return z * scale


def project_nonneg(z: np.ndarray) -> np.ndarray:
    return np.maximum(z, 0.0)


def project_box(z: np.ndarray, lo: float, hi: float) -> np.ndarray:
    return np.clip(z, lo, hi)


def project_l1_ball(z: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Euclidean projection onto {x : ‖x‖₁ ≤ radius} (sort-based)."""
    shape = z.shape
    v = z.ravel()
    mag = np.abs(v)
    if mag.sum() <= radius:
        return z
    u = np.sort(mag)[::-1]
    css = np.cumsum(u)
    ks = np.arange(1, u.size + 1)
    rho = np.max(np.nonzero(u * ks > (css - radius))[0]) + 1
    theta = (css[rho - 1] - radius) / rho
    out = shrink(v, theta)
    return out.reshape(shape)


def svt(Z: np.ndarray, t: float) -> np.ndarray:
    """Singular-value thresholding: prox of t·‖·‖_* (nuclear norm)."""
    U, s, Vh = np.linalg.svd(Z, full_matrices=False)
    s = np.maximum(s - t, 0.0)
    return (U * s) @ Vh


def prox_linf(z: np.ndarray, t: float) -> np.ndarray:
    """Prox of t·‖·‖∞ via Moreau: z − t·P_{‖·‖₁≤1}(z/t).
    Degenerate t ≤ 0 returns z (identity prox of the zero function)."""
    if t <= 0:
        return z
    return z - t * project_l1_ball(z / t, 1.0)


def shrink_rows(Z: np.ndarray, t: float) -> np.ndarray:
    """Row-wise group soft threshold — prox of t·‖·‖_{2,1}."""
    norms = np.linalg.norm(Z, axis=-1, keepdims=True)
    scale = np.maximum(norms - t, 0.0) / np.maximum(norms, 1e-30)
    return Z * scale


def project_max_row_norm(Z: np.ndarray, radius: float) -> np.ndarray:
    """Project each row onto the L2 ball of the given radius (max-norm
    factorization constraint)."""
    norms = np.linalg.norm(Z, axis=-1, keepdims=True)
    scale = np.minimum(norms, radius) / np.maximum(norms, 1e-30)
    return Z * scale


# --------------------------------------------------------------------------
# TV operator (E4): forward differences + negative-divergence adjoint.
# --------------------------------------------------------------------------

def tv_grad_2d(x: np.ndarray) -> np.ndarray:
    """2-D discrete gradient (forward differences, Neumann boundary).

    x: (H, W) → out: (2, H, W); out[0] vertical diffs, out[1] horizontal.
    Last row/col of each channel is zero.
    """
    g = np.zeros((2,) + x.shape, dtype=x.dtype)
    g[0, :-1, :] = x[1:, :] - x[:-1, :]
    g[1, :, :-1] = x[:, 1:] - x[:, :-1]
    return g


def tv_div_2d(p: np.ndarray) -> np.ndarray:
    """Adjoint of tv_grad_2d: (2, H, W) → (H, W), equals −divergence."""
    out = np.zeros(p.shape[1:], dtype=p.dtype)
    # adjoint of vertical forward difference
    out[:-1, :] -= p[0, :-1, :]
    out[1:, :] += p[0, :-1, :]
    # adjoint of horizontal forward difference
    out[:, :-1] -= p[1, :, :-1]
    out[:, 1:] += p[1, :, :-1]
    return out


# --------------------------------------------------------------------------
# E1 — LASSO / BPDN:  min ½‖Ax−b‖² + μ‖x‖₁
# --------------------------------------------------------------------------

def make_lasso(m: int = 1000, n: int = 2000, k: int = 100, mu: float = 0.1,
               sigma: float = 0.01, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    support = rng.choice(n, size=k, replace=False)
    x_true[support] = rng.standard_normal(k)
    b = A @ x_true + sigma * rng.standard_normal(m)
    x0 = np.zeros(n)

    return dict(
        name="lasso", A=A, b=b, x_true=x_true, x0=x0, mu=mu, seed=seed,
        f=lambda d: 0.5 * np.linalg.norm(d - b) ** 2,
        gradf=lambda d: d - b,
        g=lambda x: mu * np.abs(x).sum(),
        proxg=lambda z, t: shrink(z, t * mu),
        op=A, op_t=None,
    )


# --------------------------------------------------------------------------
# E2 — Non-negative least squares:  min ½‖Ax−b‖²  s.t. x ≥ 0
# --------------------------------------------------------------------------

def make_nnls(m: int = 1000, n: int = 500, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.maximum(rng.standard_normal(n), 0.0)
    b = A @ x_true + 0.01 * rng.standard_normal(m)
    x0 = np.zeros(n)
    return dict(
        name="nnls", A=A, b=b, x_true=x_true, x0=x0, mu=0.0, seed=seed,
        f=lambda d: 0.5 * np.linalg.norm(d - b) ** 2,
        gradf=lambda d: d - b,
        g=lambda x: 0.0,                     # indicator of the nonneg cone
        proxg=lambda z, t: project_nonneg(z),
        op=A, op_t=None,
    )


# --------------------------------------------------------------------------
# E3 — Sparse logistic regression:  min logit(Ax; b) + μ‖x‖₁
#      logit(d; b) = Σ log(1+exp(d_i)) − bᵀd,  b ∈ {0,1}^m
# --------------------------------------------------------------------------

def make_logistic(m: int = 1000, n: int = 500, k: int = 20, mu: float = 0.02,
                  seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    support = rng.choice(n, size=k, replace=False)
    x_true[support] = rng.standard_normal(k) * 4.0
    p = 1.0 / (1.0 + np.exp(-(A @ x_true)))
    b = (rng.random(m) < p).astype(np.float64)
    x0 = np.zeros(n)

    def f(d):
        # log(1+exp(d)) computed stably: max(d,0) + log1p(exp(-|d|))
        return float(np.sum(np.maximum(d, 0.0) + np.log1p(np.exp(-np.abs(d)))
                            - b * d))

    def gradf(d):
        return 1.0 / (1.0 + np.exp(-d)) - b

    return dict(
        name="logistic", A=A, b=b, x_true=x_true, x0=x0, mu=mu, seed=seed,
        f=f, gradf=gradf,
        g=lambda x: mu * np.abs(x).sum(),
        proxg=lambda z, t: shrink(z, t * mu),
        op=A, op_t=None,
    )


# --------------------------------------------------------------------------
# E4 — Total-variation denoising:  min ½‖x−b‖² + μ·TV(x), solved on the dual
#
#      FASTA solves the dual:  min_p ½‖b − μ·div*(p)‖²  s.t. ‖p‖∞ ≤ 1
#      where div* = tv_div_2d (adjoint of the gradient).  In FASTA form:
#        f(d) = ½‖b − μ d‖² with d = At·... — we keep it primal-friendly by
#      taking A = tv_div_2d (the (2,H,W)→(H,W) operator scaled by μ),
#        f(Ap) = ½‖Ap − b‖²,  g = indicator{‖p‖∞ ≤ 1} (per-component box),
#      recovered image x* = b − μ·div*(p*).
# --------------------------------------------------------------------------

def make_tv(h: int = 512, w: int = 512, mu: float = 0.1, sigma: float = 0.1,
            seed: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    # piecewise-constant synthetic image: random rectangles
    img = np.zeros((h, w))
    for _ in range(12):
        r0, c0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        r1 = r0 + int(rng.integers(h // 8, h // 2))
        c1 = c0 + int(rng.integers(w // 8, w // 2))
        img[r0:r1, c0:c1] += rng.standard_normal()
    img = (img - img.min()) / max(img.max() - img.min(), 1e-12)
    b = img + sigma * rng.standard_normal((h, w))
    p0 = np.zeros((2, h, w))

    A = lambda p: mu * tv_div_2d(p)         # (2,H,W) -> (H,W)
    At = lambda y: mu * tv_grad_2d(y)        # (H,W) -> (2,H,W)

    return dict(
        name="tv", b=b, x_true=img, x0=p0, mu=mu, seed=seed,
        f=lambda d: 0.5 * np.linalg.norm(d - b) ** 2,
        gradf=lambda d: d - b,
        g=lambda p: 0.0,                     # indicator of the ∞-ball
        proxg=lambda z, t: project_box(z, -1.0, 1.0),
        op=A, op_t=At,
        recover=lambda p: b - mu * tv_div_2d(p),
    )


# --------------------------------------------------------------------------
# E5 — Phase retrieval (PhaseMax-style): recover x from b = |Ax|.
#
#      PhaseMax relaxation:  max Re<x0_hat, x>  s.t. |a_iᴴx| ≤ b_i,
#      solved as FBS on the penalized form
#        min  Σ_i max(|d_i| − b_i, 0)²·½  −  δ·Re<x0_hat, x>
#      i.e. f(d) = ½ Σ max(|d|−b,0)²  (smooth hinge on the circular
#      constraint), g(x) = −δ·Re<x0_hat,x> with a linear-shift prox.
#      Complex A ∈ ℂ^{m×n}; all solver inner products take real parts.
# --------------------------------------------------------------------------

def make_phase_retrieval(m: int = 16384, n: int = 256, delta: float = 0.1,
                         anchor_noise: float = 0.5, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n)))
    A /= np.sqrt(2 * m)
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = np.abs(A @ x_true)
    # spectral-free initializer: a reproducible anchor correlated with x_true
    # (plays the role of PhaseMax's spectral/truncated initializer; cos angle
    # to the truth ≈ 0.9 at the default anchor_noise).
    x0_hat = x_true + (anchor_noise * np.linalg.norm(x_true) / np.sqrt(2 * n)
                       ) * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
    x0_hat /= np.linalg.norm(x0_hat)
    x0 = x0_hat.copy()

    def f(d):
        r = np.maximum(np.abs(d) - b, 0.0)
        return 0.5 * float(np.sum(r * r))

    def gradf(d):
        mag = np.abs(d)
        r = np.maximum(mag - b, 0.0)
        return r * d / np.maximum(mag, 1e-30)

    def g(x):
        return -delta * float(np.real(np.vdot(x0_hat, x)))

    def proxg(z, t):
        return z + t * delta * x0_hat

    return dict(
        name="phase_retrieval", A=A, b=b, x_true=x_true, x0=x0,
        x0_hat=x0_hat, delta=delta, mu=0.0, seed=seed,
        f=f, gradf=gradf, g=g, proxg=proxg,
        op=A, op_t=None,
    )


# --------------------------------------------------------------------------
# E5b — Coded-diffraction phase retrieval: b = |F(m_k ⊙ x)| for K random
#       modulation masks m_k (structured operator — no dense matrix).
#       Same PhaseMax hinge objective as E5; the operator is a stack of
#       modulated unitary FFTs with exact adjoint conj(m_k)⊙IFFT.
# --------------------------------------------------------------------------

def make_phase_retrieval_cdp(n: int = 256, K: int = 8, delta: float = 0.1,
                             anchor_noise: float = 0.5,
                             seed: int = 10) -> dict:
    rng = np.random.default_rng(seed)
    # random phase masks (unit magnitude)
    masks = np.exp(2j * np.pi * rng.random((K, n)))
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)

    def op(x):
        return np.stack([np.fft.fft(m * x, norm="ortho") for m in masks])

    def op_t(Y):
        out = np.zeros(n, dtype=complex)
        for k in range(K):
            out += np.conj(masks[k]) * np.fft.ifft(Y[k], norm="ortho")
        return out

    b = np.abs(op(x_true))
    x0_hat = x_true + (anchor_noise * np.linalg.norm(x_true) / np.sqrt(2 * n)
                       ) * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
    x0_hat /= np.linalg.norm(x0_hat)
    x0 = x0_hat.copy()

    def f(d):
        r = np.maximum(np.abs(d) - b, 0.0)
        return 0.5 * float(np.sum(r * r))

    def gradf(d):
        mag = np.abs(d)
        r = np.maximum(mag - b, 0.0)
        return r * d / np.maximum(mag, 1e-30)

    def g(x):
        return -delta * float(np.real(np.vdot(x0_hat, x)))

    def proxg(z, t):
        return z + t * delta * x0_hat

    return dict(
        name="phase_retrieval_cdp", masks=masks, b=b, x_true=x_true, x0=x0,
        x0_hat=x0_hat, delta=delta, mu=0.0, seed=seed,
        f=f, gradf=gradf, g=g, proxg=proxg,
        op=op, op_t=op_t,
    )


# --------------------------------------------------------------------------
# E6 — Democratic representations:  min ½‖Ax−b‖² + μ‖x‖∞
#      (spread the signal energy democratically across a redundant frame;
#      prox of the L∞ norm via L1-ball projection of the dual).
# --------------------------------------------------------------------------

def make_democratic(m: int = 256, n: int = 1024, mu: float = 3.0,
                    seed: int = 6) -> dict:
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = rng.standard_normal(m)
    x0 = np.zeros(n)
    return dict(
        name="democratic", A=A, b=b, x_true=None, x0=x0, mu=mu, seed=seed,
        f=lambda d: 0.5 * np.linalg.norm(d - b) ** 2,
        gradf=lambda d: d - b,
        g=lambda x: mu * np.max(np.abs(x)) if x.size else 0.0,
        proxg=lambda z, t: prox_linf(z, t * mu),
        op=A, op_t=None,
    )


# --------------------------------------------------------------------------
# E7 — Multiple-measurement vector (MMV):  min ½‖AX−B‖²_F + μ‖X‖_{2,1}
#      (joint row-sparse recovery; group shrink prox).
# --------------------------------------------------------------------------

def make_mmv(m: int = 400, n: int = 800, l: int = 10, k: int = 40,
             mu: float = 0.2, sigma: float = 0.01, seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    X_true = np.zeros((n, l))
    support = rng.choice(n, size=k, replace=False)
    X_true[support] = rng.standard_normal((k, l))
    B = A @ X_true + sigma * rng.standard_normal((m, l))
    X0 = np.zeros((n, l))
    return dict(
        name="mmv", A=A, b=B, x_true=X_true, x0=X0, mu=mu, seed=seed,
        f=lambda D: 0.5 * np.linalg.norm((D - B).ravel()) ** 2,
        gradf=lambda D: D - B,
        g=lambda X: mu * np.sum(np.linalg.norm(X, axis=-1)),
        proxg=lambda Z, t: shrink_rows(Z, t * mu),
        op=lambda X: A @ X, op_t=lambda Y: A.T @ Y,
    )


# --------------------------------------------------------------------------
# E8 — 1-bit (logistic) matrix completion:
#      min Σ_{(i,j)∈Ω} log(1+exp(X_ij)) − Y_ij X_ij  +  μ‖X‖_*
#      (low-rank logit matrix from observed signs; SVT prox; A = identity).
# --------------------------------------------------------------------------

def make_matrix_completion(d1: int = 200, d2: int = 200, rank: int = 5,
                           obs_frac: float = 0.3, mu: float = 2.0,
                           seed: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((d1, rank))
    V = rng.standard_normal((d2, rank))
    M = (U @ V.T) / np.sqrt(rank)
    mask = (rng.random((d1, d2)) < obs_frac).astype(np.float64)
    p = 1.0 / (1.0 + np.exp(-M))
    Y = (rng.random((d1, d2)) < p).astype(np.float64) * mask
    X0 = np.zeros((d1, d2))

    def f(D):
        loss = np.maximum(D, 0.0) + np.log1p(np.exp(-np.abs(D))) - Y * D
        return float(np.sum(mask * loss))

    def gradf(D):
        return mask * (1.0 / (1.0 + np.exp(-D)) - Y)

    return dict(
        name="matrix_completion", A=None, b=Y, mask=mask, x_true=M, x0=X0,
        mu=mu, seed=seed,
        f=f, gradf=gradf,
        g=lambda X: mu * np.sum(np.linalg.svd(X, compute_uv=False)),
        proxg=lambda Z, t: svt(Z, t * mu),
        op=None, op_t=None,
    )


# --------------------------------------------------------------------------
# E10 — Linear SVM (squared hinge):
#       min ½ Σ max(0, 1 − y_i·(Ax)_i)² + λ/2‖x‖²
#       smooth squared hinge as f; g = λ/2‖·‖² with prox z/(1+tλ).
# --------------------------------------------------------------------------

def make_svm(m: int = 800, n: int = 100, lam: float = 0.01,
             seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    margin = A @ w_true
    y = np.sign(margin + 0.3 * rng.standard_normal(m))
    y[y == 0] = 1.0
    x0 = np.zeros(n)

    def f(d):
        r = np.maximum(0.0, 1.0 - y * d)
        return 0.5 * float(np.sum(r * r))

    def gradf(d):
        r = np.maximum(0.0, 1.0 - y * d)
        return -y * r

    return dict(
        name="svm", A=A, b=y, x_true=w_true, x0=x0, mu=lam, lam=lam,
        seed=seed,
        f=f, gradf=gradf,
        g=lambda x: 0.5 * lam * float(np.dot(x, x)),
        proxg=lambda z, t: z / (1.0 + t * lam),
        op=A, op_t=None,
    )


# --------------------------------------------------------------------------
# E9 — Max-norm regularization:  min ½‖X−B‖²_F  s.t. max_i ‖X_i,:‖₂ ≤ c
#      (the max-norm ball constraint on the stacked factor; rowwise
#      L2-ball projection prox).
# --------------------------------------------------------------------------

def make_max_norm(d1: int = 300, d2: int = 60, radius: float = 1.0,
                  seed: int = 9) -> dict:
    rng = np.random.default_rng(seed)
    X_true = project_max_row_norm(rng.standard_normal((d1, d2)), radius)
    B = X_true + 0.1 * rng.standard_normal((d1, d2))
    X0 = np.zeros((d1, d2))
    return dict(
        name="max_norm", A=None, b=B, x_true=X_true, x0=X0, mu=0.0,
        radius=radius, seed=seed,
        f=lambda D: 0.5 * np.linalg.norm((D - B).ravel()) ** 2,
        gradf=lambda D: D - B,
        g=lambda X: 0.0,
        proxg=lambda Z, t: project_max_row_norm(Z, radius),
        op=None, op_t=None,
    )


# --------------------------------------------------------------------------
# E10 — Sparse-operator LASSO:  min ½‖Ax−b‖² + μ‖x‖₁ with a SPARSE A
#       (the reference accepts scipy.sparse operators via its linalg
#       wrapper — capability C2; the JAX side maps this to a BCOO
#       SparseOp).
# --------------------------------------------------------------------------

def make_sparse_lasso(m: int = 1500, n: int = 3000, density: float = 0.02,
                      k: int = 80, mu: float = 0.1, sigma: float = 0.01,
                      seed: int = 12) -> dict:
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, format="csr",
                  random_state=rng, data_rvs=rng.standard_normal)
    # scale so columns have ≈unit expected norm (matches the dense
    # Gaussian A/√m convention at this density)
    A = A / np.sqrt(max(density * m, 1.0))
    x_true = np.zeros(n)
    support = rng.choice(n, size=k, replace=False)
    x_true[support] = rng.standard_normal(k)
    b = A @ x_true + sigma * rng.standard_normal(m)
    x0 = np.zeros(n)
    return dict(
        name="sparse_lasso", A_sparse=A, A=None, b=b, x_true=x_true,
        x0=x0, mu=mu, density=density, seed=seed,
        f=lambda d: 0.5 * np.linalg.norm(d - b) ** 2,
        gradf=lambda d: d - b,
        g=lambda x: mu * np.abs(x).sum(),
        proxg=lambda z, t: shrink(z, t * mu),
        op=lambda x: A @ x, op_t=lambda y: A.T @ y,
    )


# --------------------------------------------------------------------------
# E11 — Non-negative matrix factorization (the [P1] paper's remaining FBS
#       application):  min ½‖Y − W Hᵀ‖²_F  s.t. W ≥ 0, H ≥ 0,
#       solved jointly over the stacked variable X = [W; H] with the
#       identity operator — f is smooth (nonconvex), g the nonnegative
#       indicator.  FBS iterates are well-defined; parity is trajectory
#       parity, not global optimality.
# --------------------------------------------------------------------------

def make_nmf(d1: int = 80, d2: int = 60, r: int = 5, sigma: float = 0.01,
             seed: int = 13) -> dict:
    rng = np.random.default_rng(seed)
    W_true = np.abs(rng.standard_normal((d1, r)))
    H_true = np.abs(rng.standard_normal((d2, r)))
    Y_clean = W_true @ H_true.T
    Y = Y_clean + sigma * rng.standard_normal((d1, d2))
    X0 = np.abs(rng.standard_normal((d1 + d2, r))) * 0.5

    def f(X):
        R = X[:d1] @ X[d1:].T - Y
        return 0.5 * float(np.sum(R * R))

    def gradf(X):
        W, H = X[:d1], X[d1:]
        R = W @ H.T - Y
        return np.concatenate([R @ H, R.T @ W], axis=0)

    return dict(
        name="nmf", A=None, b=Y, x_true=Y_clean, x0=X0, mu=0.0,
        d1=d1, d2=d2, rank=r, seed=seed,
        f=f, gradf=gradf,
        g=lambda X: 0.0,
        proxg=lambda Z, t: project_nonneg(Z),
        op=None, op_t=None,
    )
