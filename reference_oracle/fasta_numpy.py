"""Float64 NumPy oracle for the FASTA solver — THE in-repo algorithm spec.

The upstream reference (phasepack/fasta-python) could not be mounted
(/root/reference is empty — see SURVEY.md §0), so this module is the
authoritative specification of the algorithm the JAX build must match,
reconstructed from the FASTA papers:

  [P1] arXiv:1501.04979 — "FASTA: A Generalized Implementation of
       Forward-Backward Splitting" (user manual: interface, options,
       enhancements)
  [P2] arXiv:1411.3406 — "A Field Guide to Forward-Backward Splitting with
       a FASTA Implementation" (algorithm math: BB stepsize, nonmonotone
       line search, restart rules)

Solves   min_x  f(A x) + g(x)
with f smooth (gradient available) and g "simple" (prox available), via
forward-backward splitting with the [P1]/[P2] enhancements:

  * adaptive spectral (Barzilai–Borwein) stepsize, Zhou–Gao–Dai hybrid rule
  * nonmonotone backtracking line search (window of the last W f-values)
  * FISTA acceleration with O'Donoghue–Candès adaptive restart
  * selectable stopping rules (residual / normalized / ratio / hybrid)
  * full per-iteration diagnostics

Everything here is float64 NumPy, single process.  The JAX solver in
``fasta_tpu/solver.py`` implements the *identical* iteration math (same
update order, same stepsize formulas, same stopping logic) so that the two
trajectories agree within floating-point tolerance; the parity tests in
``tests/parity/`` enforce this.

Algorithm spec (one iteration, mirroring the state carried by the solver):

    x0 <- x1 ; gradf0 <- gradf1 ; tau0 <- tau1
    x1hat = x0 - tau0 * gradf0
    x1    = proxg(x1hat, tau0)
    Dx    = x1 - x0 ;  d1 = A x1 ;  f1 = f(d1)
    [backtrack]  M = max(last W recorded f-values); the recorded value is
                 f at the SEARCH point entering the next iteration (the
                 extrapolated y when accelerating, the prox point
                 otherwise) — this is what makes the nonmonotone test
                 terminate for tau <= 1/L (descent lemma at y)
        while f1 - 1e-12 > M + Re<Dx, gradf0> + ||Dx||^2/(2 tau0)
              and count < max_backtracks:
            tau0 *= stepsize_shrink ; redo x1hat, x1, Dx, d1, f1
    residual   = ||Dx|| / tau0                       (gradient-map norm)
    normalizer = max(||gradf0||, ||x1 - x1hat||/tau0) + eps_n
    [record diagnostics; track best iterate; evaluate stopping rule]
    [adaptive]   gradf1 = At gradf(d1)
                 Dg = gradf1 + (x1hat - x0)/tau0        (== gradf1 - gradf0)
                 dotprod = Re<Dx, Dg>
                 tau_s = ||Dx||^2 / dotprod  ;  tau_m = dotprod / ||Dg||^2
                 tau_m = max(tau_m, 0)
                 tau1  = tau_m              if 2 tau_m > tau_s
                         tau_s - tau_m/2    otherwise
                 tau1  = tau0 * 1.5         if tau1 <= 0 / inf / nan
    [accelerate] x_accel0 <- x_accel1 ; d_accel0 <- d_accel1 ; a0 <- a1
                 x_accel1 = x1 ; d_accel1 = d1
                 restart:  a0 <- 1  if Re<x0 - x1, x1 - x_accel0> > 0
                 a1 = (1 + sqrt(1 + 4 a0^2)) / 2
                 x1 = x_accel1 + (a0-1)/a1 * (x_accel1 - x_accel0)
                 d1 = d_accel1 + (a0-1)/a1 * (d_accel1 - d_accel0)
                 gradf1 = At gradf(d1) ; f1 = f(d1) ; tau1 = tau0
                 (this f1 — at the EXTRAPOLATED point — is what enters
                  the nonmonotone window and the fvals record: see the
                  window-semantics note in [backtrack] above)
    [plain]      gradf1 = At gradf(d1) ; tau1 = tau0

Note the single-matvec trick: because A is linear, the accelerated point's
image d = A y is formed by the same linear combination as y itself — no
extra matvec.  Plain/adaptive modes reuse gradf1 as the next iteration's
gradf0 (y_{k+1} = x_{k+1}).  Cost: 2 matvecs per plain/accelerated
iteration, 2 per adaptive iteration (gradf at x1 doubles as BB input and
next gradf0), plus 1 matvec per backtracking trial.

All inner products take real parts (Re<a, b> = Re sum conj(a)*b) so the
solver is correct over complex vector spaces (phase retrieval).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np

__all__ = ["fasta", "FastaResult", "STOP_RULES"]

STOP_RULES = (
    "residual",
    "normalized_residual",
    "ratio_residual",
    "hybrid_residual",
    "iterations",
)


def _redot(a: np.ndarray, b: np.ndarray) -> float:
    """Re<a, b> over arbitrary-shape (possibly complex) arrays."""
    return float(np.real(np.vdot(a, b)))


def _norm(a: np.ndarray) -> float:
    """Frobenius/L2 norm of an arbitrary-shape (possibly complex) array."""
    return float(np.linalg.norm(a.ravel()))


@dataclass
class FastaResult:
    """Solver output: solution + full per-iteration diagnostics.

    Mirrors the output fields of the reference solver ([P1] §5 outputs):
    solution, best iterate, residuals, normalized residuals, stepsizes,
    function values, objective values, backtrack counts, iteration count,
    solve time, and (optionally) all iterates.
    """

    solution: np.ndarray
    best_iterate: np.ndarray
    iteration_count: int
    converged: bool
    residuals: np.ndarray            # ||x1 - x0|| / tau per iteration
    norm_residuals: np.ndarray       # residual / (normalizer + eps_n)
    taus: np.ndarray                 # accepted stepsize per iteration
    fvals: np.ndarray                # f(A x1) per iteration
    objectives: Optional[np.ndarray]  # f + g per iteration (if recorded)
    backtracks: np.ndarray           # backtracking trials per iteration
    total_backtracks: int
    solve_time: float
    L_estimate: Optional[float]
    initial_tau: float
    iterates: Optional[List[np.ndarray]] = None
    extras: dict = field(default_factory=dict)


def _as_op_pair(A: Any, At: Any, x0: np.ndarray):
    """Normalize (A, At) into a callable pair.

    Accepts: a dense ndarray (At may be None -> conjugate transpose), a pair
    of callables, or (None, None) for the identity (capability C2 in
    SURVEY.md §2.1).
    """
    if A is None:
        return (lambda x: x), (lambda y: y)
    if isinstance(A, np.ndarray):
        M = A
        fwd = lambda x: M @ x
        adj = (lambda y: M.conj().T @ y) if At is None else (
            At if callable(At) else (lambda y, Mt=At: Mt @ y))
        return fwd, adj
    if callable(A):
        if not callable(At):
            raise ValueError("A is a callable; At must be a callable adjoint")
        return A, At
    raise TypeError(f"unsupported operator type: {type(A)}")


def check_adjoint(A, At, x_like: np.ndarray, d_like: np.ndarray,
                  rng: np.random.Generator, rtol: float = 1e-9) -> float:
    """Verify <A x, y> == <x, At y> on random vectors ([P1] §5 adjoint check)."""
    def randn_like(v):
        r = rng.standard_normal(v.shape)
        if np.iscomplexobj(v):
            r = r + 1j * rng.standard_normal(v.shape)
        return r.astype(v.dtype)

    x = randn_like(x_like)
    y = randn_like(d_like)
    lhs = np.vdot(y, A(x))
    rhs = np.vdot(At(y), x)
    scale = max(abs(lhs), abs(rhs), 1e-30)
    err = abs(lhs - rhs) / scale
    if err > rtol:
        raise ValueError(
            f"adjoint check failed: <Ax,y>={lhs} vs <x,At y>={rhs} "
            f"(rel err {err:.3e})")
    return err


def fasta(
    A: Any,
    At: Any,
    f: Callable[[np.ndarray], float],
    gradf: Callable[[np.ndarray], np.ndarray],
    g: Callable[[np.ndarray], float],
    proxg: Callable[[np.ndarray, float], np.ndarray],
    x0: np.ndarray,
    *,
    max_iters: int = 1000,
    tol: float = 1e-3,
    adaptive: bool = True,
    accelerate: bool = False,
    backtrack: bool = True,
    restart: bool = True,
    window: int = 10,
    max_backtracks: int = 20,
    stepsize_shrink: Optional[float] = None,
    eps_r: float = 1e-8,
    eps_n: float = 1e-8,
    stop_rule: str = "hybrid_residual",
    tau0: Optional[float] = None,
    L: Optional[float] = None,
    record_objective: bool = False,
    record_iterates: bool = False,
    verbose: bool = False,
    check_adjoint_first: bool = False,
    rng: Optional[np.random.Generator] = None,
    est_points: Optional[tuple] = None,
) -> FastaResult:
    """Forward-backward splitting solver for min f(Ax) + g(x).

    This is the reference-compatible entry point (C1 in SURVEY.md §2.1): a
    single function taking the operator pair, smooth term (f, gradf), simple
    term (g, proxg), initial iterate and keyword options.  Defaults follow
    [P1] §5: adaptive BB on, acceleration off, backtracking on, window 10,
    stepsize_shrink 0.2 when adaptive else 0.5, hybrid residual stopping.
    """
    if stop_rule not in STOP_RULES:
        raise ValueError(f"stop_rule must be one of {STOP_RULES}")
    if stepsize_shrink is None:
        stepsize_shrink = 0.2 if adaptive else 0.5
    if rng is None:
        rng = np.random.default_rng(0)

    Afun, Atfun = _as_op_pair(A, At, x0)
    if check_adjoint_first:
        check_adjoint(Afun, Atfun, x0, Afun(x0), rng)

    x0 = np.asarray(x0)

    # --- C8: Lipschitz / initial-stepsize estimation ---------------------
    L_est = None
    if tau0 is None:
        if L is None:
            if est_points is not None:
                # RNG-parity mode (SURVEY.md §7 hard part 5): the two
                # estimation points are generated once in NumPy and fed
                # to BOTH this oracle and the JAX solver, so auto-τ₀
                # runs are trajectory-comparable.
                z1, z2 = (np.asarray(est_points[0], dtype=x0.dtype),
                          np.asarray(est_points[1], dtype=x0.dtype))
            else:
                def randn_like(v):
                    r = rng.standard_normal(v.shape)
                    if np.iscomplexobj(v):
                        r = r + 1j * rng.standard_normal(v.shape)
                    return r.astype(v.dtype)
                z1, z2 = randn_like(x0), randn_like(x0)
            g1 = Atfun(gradf(Afun(z1)))
            g2 = Atfun(gradf(Afun(z2)))
            L = _norm(g1 - g2) / max(_norm(z2 - z1), 1e-30)
            L = max(L, 1e-6)
            L_est = L
        tau0 = 2.0 / L / 10.0        # tau0 = (2/L)/10, [P1]/MATLAB convention
    assert tau0 > 0, "initial stepsize must be positive"
    initial_tau = float(tau0)

    t_start = time.perf_counter()

    # --- initialization ---------------------------------------------------
    x1 = x0.copy()
    d1 = Afun(x1)
    f1 = float(f(d1))
    gradf1 = Atfun(gradf(d1))
    tau1 = float(tau0)

    # Nonmonotone window: ring buffer of the last `window` recorded f-values,
    # seeded with f(A x0) so iteration 0's sufficient-decrease test compares
    # against the starting objective.
    fwin = np.full(window, -np.inf)
    fwin[0] = f1

    if accelerate:
        x_accel1 = x1.copy()
        d_accel1 = np.copy(d1)
        alpha1 = 1.0

    residuals = np.zeros(max_iters)
    norm_residuals = np.zeros(max_iters)
    taus = np.zeros(max_iters)
    fvals = np.zeros(max_iters)
    backtracks = np.zeros(max_iters, dtype=np.int64)
    objectives = np.zeros(max_iters) if record_objective else None
    iterates: Optional[List[np.ndarray]] = [] if record_iterates else None

    max_residual = -np.inf
    min_objective = np.inf
    best_x = x1.copy()
    total_backtracks = 0
    converged = False
    n_done = max_iters

    for i in range(max_iters):
        x0_, gradf0, tau_i = x1, gradf1, tau1

        # forward (gradient) step + backward (prox) step
        x1hat = x0_ - tau_i * gradf0
        x1 = proxg(x1hat, tau_i)
        Dx = x1 - x0_
        d1 = Afun(x1)
        f1 = float(f(d1))

        bt = 0
        if backtrack:
            M = float(np.max(fwin))
            # nonmonotone sufficient-decrease (Zhang–Hager style, [P2] §4)
            while (f1 - 1e-12 > M + _redot(Dx, gradf0)
                   + _norm(Dx) ** 2 / (2.0 * tau_i)
                   and bt < max_backtracks):
                tau_i = tau_i * stepsize_shrink
                x1hat = x0_ - tau_i * gradf0
                x1 = proxg(x1hat, tau_i)
                d1 = Afun(x1)
                f1 = float(f(d1))
                Dx = x1 - x0_
                bt += 1
        total_backtracks += bt
        backtracks[i] = bt

        # --- C4/C5: residuals, diagnostics, best-iterate tracking --------
        taus[i] = tau_i
        res = _norm(Dx) / tau_i
        residuals[i] = res
        max_residual = max(max_residual, res)
        normalizer = max(_norm(gradf0), _norm(x1 - x1hat) / tau_i) + eps_n
        nres = res / normalizer
        norm_residuals[i] = nres
        fvals[i] = f1           # overwritten post-accel (window semantics)
        if record_objective:
            obj = f1 + float(g(x1))
            objectives[i] = obj
            new_obj = obj
        else:
            new_obj = res
        if new_obj < min_objective:
            min_objective = new_obj
            best_x = x1.copy()
        if record_iterates:
            iterates.append(x1.copy())
        if verbose:
            print(f"[fasta-oracle] iter {i:5d}  tau {tau_i:.3e}  "
                  f"resid {res:.3e}  nresid {nres:.3e}  f {f1:.6e}  bt {bt}")

        # --- stopping rules ----------------------------------------------
        if stop_rule == "residual":
            stop = res < tol
        elif stop_rule == "normalized_residual":
            stop = nres < tol
        elif stop_rule == "ratio_residual":
            stop = res / (max_residual + eps_r) < tol
        elif stop_rule == "hybrid_residual":
            stop = (res / (max_residual + eps_r) < tol) or (nres < tol)
        else:  # "iterations"
            stop = False
        if stop:
            converged = True
            n_done = i + 1
            fwin[(i + 1) % window] = f1
            break

        # --- mode-specific updates ----------------------------------------
        if adaptive and not accelerate:
            gradf1 = Atfun(gradf(d1))
            Dg = gradf1 + (x1hat - x0_) / tau_i   # == gradf1 - gradf0
            dotprod = _redot(Dx, Dg)
            tau_s = _norm(Dx) ** 2 / dotprod if dotprod != 0 else np.inf
            tau_m = dotprod / _norm(Dg) ** 2 if _norm(Dg) > 0 else 0.0
            tau_m = max(tau_m, 0.0)
            if 2.0 * tau_m > tau_s:
                tau1 = tau_m
            else:
                tau1 = tau_s - 0.5 * tau_m
            if (tau1 <= 0.0) or np.isinf(tau1) or np.isnan(tau1):
                tau1 = tau_i * 1.5
        elif accelerate:
            x_accel0, d_accel0, alpha0 = x_accel1, d_accel1, alpha1
            x_accel1 = x1
            d_accel1 = d1
            # O'Donoghue–Candès gradient-based adaptive restart
            if restart and _redot(x0_ - x1, x1 - x_accel0) > 0.0:
                alpha0 = 1.0
            alpha1 = (1.0 + np.sqrt(1.0 + 4.0 * alpha0 ** 2)) / 2.0
            beta = (alpha0 - 1.0) / alpha1
            x1 = x_accel1 + beta * (x_accel1 - x_accel0)
            d1 = d_accel1 + beta * (d_accel1 - d_accel0)  # A is linear
            gradf1 = Atfun(gradf(d1))
            f1 = float(f(d1))
            fvals[i] = f1        # window records f at the NEXT search
            tau1 = tau_i         # point y_{k+1} (see module docstring)
        else:
            gradf1 = Atfun(gradf(d1))
            tau1 = tau_i

        # Nonmonotone-window entry: f at the next search point.  In the
        # accelerated mode this is the EXTRAPOLATED point — the descent
        # lemma then guarantees the next backtracking loop terminates at
        # tau <= 1/L (recording the prox-point f instead lets f(y) sit
        # above the window max and collapses tau to zero).
        fwin[(i + 1) % window] = f1

    solve_time = time.perf_counter() - t_start
    k = n_done
    return FastaResult(
        solution=x1,
        best_iterate=best_x,
        iteration_count=k,
        converged=converged,
        residuals=residuals[:k],
        norm_residuals=norm_residuals[:k],
        taus=taus[:k],
        fvals=fvals[:k],
        objectives=objectives[:k] if record_objective else None,
        backtracks=backtracks[:k],
        total_backtracks=total_backtracks,
        solve_time=solve_time,
        L_estimate=L_est,
        initial_tau=initial_tau,
        iterates=iterates,
    )
