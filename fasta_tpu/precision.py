"""Double-word (compensated) floating-point arithmetic for decision scalars.

SURVEY.md §7 hard part 3: the FBS stepsize and backtracking decisions are
exquisitely sensitive to rounding in a handful of scalar reductions —
⟨Δx,Δg⟩, ‖Δx‖², ‖Δg‖², the f-values entering the nonmonotone window —
and on a float32 data path plain reductions stall convergence (TV
512×512 once needed 15,742 iterations vs the float64 oracle's 1,871).
So every decision
scalar is carried as an unevaluated pair ``hi + lo`` of float32 values
("double-word" / double-float arithmetic, à la Dekker 1971 and the
Ogita–Rump–Oishi compensated dot product), giving ≈2⁻⁴⁸ effective
precision — oracle (float64) quality — from pure float32 ops.

All transforms are *error-free*: ``two_sum`` and ``two_prod`` return the
exact rounding error of the float32 operation, so the pair algebra is
exact up to the final collapse.  ``two_prod`` uses the Dekker split (no
FMA required; each partial product is exactly representable), which stays
correct even if the compiler contracts multiply-add chains.

Reductions run as ONE variadic ``lax.reduce`` with a double-word-add
combiner by default (single fused kernel — the solver loop is
latency-bound), or as an explicit pairwise tree (``FASTA_TPU_DD_IMPL=
tree``).  Both are deterministic for a fixed shape/executable — the
cross-host determinism requirement for sharded stepsize decisions
(SURVEY.md §2.3).

The solver enables this path automatically for sub-float64 data
(``FastaOptions.precision="auto"``); the float64 parity path is untouched.

Overflow note: the Dekker split multiplies by 2¹²+1 (float32) / 2²⁷+1
(float64), so inputs with |x| ≳ 8e34 (f32) overflow the split — far
beyond any sane problem scaling; inputs that large overflow the plain
dot product too.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp
import numpy as np

__all__ = [
    "DD", "dd", "two_sum", "fast_two_sum", "two_prod",
    "dd_add", "dd_sub", "dd_neg", "dd_scale", "dd_div", "dd_div_float",
    "dd_where", "dd_max", "dd_to_float", "sum_dd", "dot_dd", "norm2_dd",
    "dot_parts", "sum_parts", "reduce_dd_many",
]


class DD(NamedTuple):
    """An unevaluated float sum ``hi + lo`` with ``|lo| ≤ ulp(hi)/2``.

    A pytree — DD scalars ride through ``lax.while_loop`` carries,
    ``jnp.where`` selections and vmap like any other leaf pair.
    """
    hi: Any
    lo: Any


def dd(x) -> DD:
    """Lift a plain float array/scalar to an exact DD."""
    x = jnp.asarray(x)
    return DD(x, jnp.zeros_like(x))


def two_sum(a, b):
    """Error-free transform: a + b = s + err exactly (Knuth/Møller)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Error-free a + b = s + err, REQUIRES |a| ≥ |b| (or a == 0)."""
    s = a + b
    err = b - (s - a)
    return s, err


# Dekker split constants: 2^ceil(p/2) + 1 for a p-bit significand.
_SPLIT_CONST = {
    np.dtype(np.float32): np.float32(4097.0),        # 2^12 + 1
    np.dtype(np.float64): np.float64(134217729.0),   # 2^27 + 1
}


def _split(a):
    a = jnp.asarray(a)
    c = _SPLIT_CONST[np.dtype(a.dtype)] * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free transform: a * b = p + err exactly (Dekker).

    Every partial product of the split halves is exactly representable,
    so the result is exact whether or not the backend contracts the
    multiply-add chains into FMAs.
    """
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def dd_add(x: DD, y: DD) -> DD:
    """Accurate double-word addition (≈2 ulp of the pair format)."""
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = fast_two_sum(s, e)
    e = e + f
    return DD(*fast_two_sum(s, e))


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_sub(x: DD, y: DD) -> DD:
    return dd_add(x, dd_neg(y))


def dd_scale(x: DD, c) -> DD:
    """DD × plain-float scalar."""
    c = jnp.asarray(c, x.hi.dtype) if hasattr(x.hi, "dtype") else c
    p, e = two_prod(x.hi, c)
    e = e + x.lo * c
    return DD(*fast_two_sum(p, e))


def dd_div_float(x: DD, c) -> DD:
    """DD ÷ plain-float scalar (one Newton correction step)."""
    c = jnp.asarray(c, x.hi.dtype) if hasattr(x.hi, "dtype") else c
    q1 = x.hi / c
    p, e = two_prod(q1, c)
    r = ((x.hi - p) - e) + x.lo
    q2 = r / c
    return DD(*fast_two_sum(q1, q2))


def dd_div(x: DD, y: DD) -> DD:
    """DD ÷ DD (long division with one correction)."""
    q1 = x.hi / y.hi
    r = dd_sub(x, dd_scale(y, q1))
    q2 = (r.hi + r.lo) / y.hi
    return DD(*fast_two_sum(q1, q2))


def dd_where(pred, x: DD, y: DD) -> DD:
    return DD(jnp.where(pred, x.hi, y.hi), jnp.where(pred, x.lo, y.lo))


def dd_max(x: DD) -> DD:
    """Lexicographic max over a DD of arrays.

    The lo tiebreak matters: near convergence successive f-values share
    the same float32 hi and differ only in lo — picking an arbitrary
    element would reintroduce exactly the ulp-level error this module
    removes from the nonmonotone window test.
    """
    mhi = jnp.max(x.hi)
    mlo = jnp.max(jnp.where(x.hi == mhi, x.lo, -jnp.inf))
    return DD(mhi, mlo)


def dd_to_float(x: DD):
    """Collapse to the nearest plain float."""
    return x.hi + x.lo


def _pairwise_dd_sum(hi, lo) -> DD:
    """Fixed pairwise-tree reduction of an (hi, lo) pair array to a DD
    scalar — log₂n vectorized double-word additions, bit-deterministic
    for a given length."""
    while hi.shape[0] > 1:
        if hi.shape[0] % 2:
            hi = jnp.concatenate([hi, jnp.zeros((1,), hi.dtype)])
            lo = jnp.concatenate([lo, jnp.zeros((1,), lo.dtype)])
        h = hi.reshape(-1, 2)
        l_ = lo.reshape(-1, 2)
        s = dd_add(DD(h[:, 0], l_[:, 0]), DD(h[:, 1], l_[:, 1]))
        hi, lo = s.hi, s.lo
    return DD(hi[0], lo[0])


def _reduce_dd_sum(hi, lo) -> DD:
    """Variadic ``lax.reduce`` with a double-word-add combiner: ONE fused
    HLO reduce instead of log₂n elementwise kernels — the latency-bound
    solver loop needs this (each extra kernel launch is paid on every
    iteration).  The backend picks the reduction order; any order of dd-adds
    keeps ≈n·2⁻⁴⁸ worst-case relative error, still float64-grade, and is
    deterministic for a fixed shape/executable."""
    import jax

    def comb(acc, val):
        s = dd_add(DD(acc[0], acc[1]), DD(val[0], val[1]))
        return (s.hi, s.lo)

    zero = (jnp.zeros((), hi.dtype), jnp.zeros((), hi.dtype))
    h, l_ = jax.lax.reduce((hi, lo), zero, comb, (0,))
    return DD(h, l_)


def _blocked_dd_sum(hi, lo) -> DD:
    """Lane-blocked compensated sum: reshape to (k, 8, 128) VPU tiles and
    dd-add them with FULLY VECTORIZED (8×128)-lane double-word adds — the
    combiner runs across all lanes at once instead of element-serially —
    then collapse the final tile with the pairwise tree.  Deterministic
    for a fixed length (fixed association order)."""
    N = hi.shape[0]
    tile = 1024
    pad = (-N) % tile
    if pad:
        hi = jnp.concatenate([hi, jnp.zeros((pad,), hi.dtype)])
        lo = jnp.concatenate([lo, jnp.zeros((pad,), lo.dtype)])
    h3 = hi.reshape(-1, 8, 128)
    l3 = lo.reshape(-1, 8, 128)
    k = h3.shape[0]
    acc = DD(h3[0], l3[0])
    if k <= 16:           # unrolled: k-1 vectorized dd_adds, no loop carry
        for i in range(1, k):
            acc = dd_add(acc, DD(h3[i], l3[i]))
    else:
        import jax

        def body(i, a):
            s = dd_add(DD(a[0], a[1]), DD(h3[i], l3[i]))
            return (s.hi, s.lo)
        h_, l_ = jax.lax.fori_loop(1, k, body, (acc.hi, acc.lo))
        acc = DD(h_, l_)
    return _pairwise_dd_sum(acc.hi.ravel(), acc.lo.ravel())


def _blocked2_dd_sum(hi, lo) -> DD:
    """Hybrid lane-blocked + small compound reduce.

    The first ``_blocked_dd_sum`` variant lost its vectorization win to
    the 10-round pairwise collapse of the final 1024-lane tile (each
    round is a reshape+strided-slice XLA no-fuse boundary).  Here the
    collapse is: (k,8,128) tiles → k−1 fully vectorized dd-adds
    (unrolled; k ≤ a few for solver-sized vectors) → 3 sublane halvings
    (widths 512/256/128, still lane-aligned) → ONE variadic
    ``lax.reduce`` over the final 128 lanes with the dd combiner — a
    single small kernel whose serial length is 128 regardless of n.
    Deterministic for a fixed length (fixed association order)."""
    import jax

    N = hi.shape[0]
    tile = 1024
    pad = (-N) % tile
    if pad:
        hi = jnp.pad(hi, (0, pad))
        lo = jnp.pad(lo, (0, pad))
    h3 = hi.reshape(-1, 8, 128)
    l3 = lo.reshape(-1, 8, 128)
    k = h3.shape[0]
    acc = DD(h3[0], l3[0])
    if k <= 32:          # unrolled: k-1 vectorized dd_adds, no loop carry
        for i in range(1, k):
            acc = dd_add(acc, DD(h3[i], l3[i]))
    else:
        def body(i, a):
            s = dd_add(DD(a[0], a[1]), DD(h3[i], l3[i]))
            return (s.hi, s.lo)
        h_, l_ = jax.lax.fori_loop(1, k, body, (acc.hi, acc.lo))
        acc = DD(h_, l_)
    for half in (4, 2, 1):                       # (8,128) → (1,128)
        acc = dd_add(DD(acc.hi[:half], acc.lo[:half]),
                     DD(acc.hi[half:], acc.lo[half:]))

    def comb(a, v):
        s = dd_add(DD(a[0], a[1]), DD(v[0], v[1]))
        return (s.hi, s.lo)

    zero = (jnp.zeros((), hi.dtype), jnp.zeros((), hi.dtype))
    h_, l_ = jax.lax.reduce((acc.hi[0], acc.lo[0]), zero, comb, (0,))
    return DD(h_, l_)


def _cast64_dd_sum(hi, lo) -> DD:
    """Sum via XLA's native (emulated) float64 reduce: exact f32→f64
    casts, two plain ``jnp.sum``s, split back to an f32 pair.  Requires
    ``jax_enable_x64``; accurate to ~n·2⁻⁵³."""
    s = jnp.sum(hi.astype(jnp.float64)) + jnp.sum(lo.astype(jnp.float64))
    h = s.astype(hi.dtype)
    return DD(h, (s - h.astype(jnp.float64)).astype(hi.dtype))


# Implementation switch.  "reduce" (default): one variadic lax.reduce
# (one kernel per reduction).  "blocked": lane-vectorized compensated
# tiles (the reshape/concat chain breaks XLA fusion into many small
# kernels).  "tree": explicit pairwise tree.  "f64": native f64 reduce
# (needs x64).  Which is fastest on the GPU is not measured yet.
# Read at TRACE time (not import) so toggling the env var mid-process
# takes effect; ``make_solver`` keys its executable cache on it.
import os as _os


def _dd_impl() -> str:
    return _os.environ.get("FASTA_TPU_DD_IMPL", "reduce")


def _dd_sum_flat(hi, lo) -> DD:
    impl = _dd_impl()
    if impl == "tree":
        return _pairwise_dd_sum(hi, lo)
    if impl == "blocked":
        return _blocked_dd_sum(hi, lo)
    if impl == "blocked2":
        return _blocked2_dd_sum(hi, lo)
    if impl == "f64":
        return _cast64_dd_sum(hi, lo)
    return _reduce_dd_sum(hi, lo)


def _dd_collapse_last(p, e):
    """dd-reduce the TRAILING axis of n-D part arrays (one ``lax.reduce``
    with the compensated combiner).  Sharding rationale: GSPMD cannot
    partition a custom-combiner reduce — raveling a sharded multi-axis
    array (e.g. the TV dual field, (2,H,W) sharded on H) therefore
    ALL-GATHERS the full operand.  Collapsing the (unsharded) trailing
    axis first runs device-local, and only the tiny per-row partials
    are gathered by the final reduction (measured: 4 KB vs 4 MB at
    512² — the gather shape shrinks by W)."""
    import jax

    def comb(a, v):
        s = dd_add(DD(a[0], a[1]), DD(v[0], v[1]))
        return (s.hi, s.lo)

    z = (jnp.zeros((), p.dtype), jnp.zeros((), p.dtype))
    return jax.lax.reduce((p, e), z, comb, (p.ndim - 1,))


def dot_parts(a, b):
    """Elementwise double-word contributions of Re⟨a,b⟩ (the Dot2
    transform WITHOUT the final reduction): 1-D ``(hi, lo)`` arrays whose
    dd-sum equals ``dot_dd(a, b)``.  Complex inputs contribute their
    real and imaginary channels as concatenated real parts.  Multi-axis
    inputs are pre-collapsed along the trailing axis (exact dd partial
    sums — see ``_dd_collapse_last`` for the sharding rationale); 1-D
    inputs take the original single-reduction path unchanged."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    if jnp.issubdtype(a.dtype, jnp.complexfloating) or \
            jnp.issubdtype(b.dtype, jnp.complexfloating):
        pr, er = dot_parts(jnp.real(a), jnp.real(b))
        pi, ei = dot_parts(jnp.imag(a), jnp.imag(b))
        return (jnp.concatenate([pr, pi]), jnp.concatenate([er, ei]))
    a = _as_real32(a)
    b = _as_real32(b)
    if a.ndim >= 2:
        p, e = two_prod(a, b)
        p, e = _dd_collapse_last(p, e)
        return jnp.ravel(p), jnp.ravel(e)
    return two_prod(jnp.ravel(a), jnp.ravel(b))


def reduce_dd_many(parts):
    """Sum k independent double-word part streams in ONE variadic
    ``lax.reduce`` — k fused compensated reductions for the dispatch
    cost of one.

    ``parts``: sequence of ``(hi, lo)`` 1-D array pairs (lengths may
    differ; shorter streams are zero-padded — an exact dd identity).
    Returns a list of k :class:`DD` sums, each bit-identical in error
    behavior to ``_reduce_dd_sum`` on its own stream (same combiner,
    same association up to trailing zeros).

    This exists for the solver's latency-bound hot loop: the three
    decision scalars of an adaptive-mode iteration (f(d), ⟨Δx,∇f⟩,
    ⟨Δx,Δg⟩) each cost a kernel launch as separate compound reduces;
    fused they cost one.
    """
    import jax

    L = max(int(p[0].shape[0]) for p in parts)
    dt = parts[0][0].dtype
    ops = []
    for hi, lo in parts:
        pad = L - int(hi.shape[0])
        if pad:
            hi = jnp.pad(hi, (0, pad))
            lo = jnp.pad(lo, (0, pad))
        ops.extend((hi, lo))

    def comb(acc, val):
        out = []
        for j in range(0, len(acc), 2):
            s = dd_add(DD(acc[j], acc[j + 1]), DD(val[j], val[j + 1]))
            out.extend((s.hi, s.lo))
        return tuple(out)

    zeros = tuple(jnp.zeros((), dt) for _ in ops)
    flat = jax.lax.reduce(tuple(ops), zeros, comb, (0,))
    return [DD(flat[j], flat[j + 1]) for j in range(0, len(flat), 2)]


def _as_real32(a):
    """Sub-float32 storage (bf16/f16) is exact in float32 — promote so
    the error-free transforms operate at full VPU precision."""
    a = jnp.asarray(a)
    if a.dtype in (jnp.bfloat16, jnp.float16):
        return a.astype(jnp.float32)
    return a


def sum_parts(x):
    """Elementwise double-word contributions of Σxᵢ — the pre-reduction
    ``(hi, lo)`` 1-D streams of :func:`sum_dd` (same trailing-axis
    pre-collapse for multi-axis inputs), for terms feeding the solver's
    fused ``reduce_dd_many`` dispatch."""
    x = _as_real32(jnp.asarray(x))
    if x.ndim >= 2:
        p, e = _dd_collapse_last(x, jnp.zeros_like(x))
        return jnp.ravel(p), jnp.ravel(e)
    x = jnp.ravel(x)
    return x, jnp.zeros_like(x)


def sum_dd(x) -> DD:
    """Σxᵢ with double-word accumulation (error ≈ n·2⁻⁴⁸ relative).
    Multi-axis inputs pre-collapse the trailing axis (sharding
    rationale in ``_dd_collapse_last``)."""
    return _dd_sum_flat(*sum_parts(x))


def dot_dd(a, b) -> DD:
    """Re⟨a, b⟩ with exact elementwise products (Dekker) and double-word
    pairwise accumulation — the Ogita–Rump–Oishi Dot2 in vectorized form:
    as accurate as computing the dot in twice the working precision."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    if jnp.issubdtype(a.dtype, jnp.complexfloating) or \
            jnp.issubdtype(b.dtype, jnp.complexfloating):
        re = dot_dd(jnp.real(a), jnp.real(b))
        im = dot_dd(jnp.imag(a), jnp.imag(b))
        return dd_add(re, im)
    p, e = dot_parts(a, b)
    return _dd_sum_flat(p, e)


def norm2_dd(a) -> DD:
    """‖a‖² with double-word accumulation (complex-safe)."""
    return dot_dd(a, a)
