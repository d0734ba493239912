"""Multi-device execution: row-sharded FASTA over a ``jax.sharding.Mesh``.

The scaling axis of this workload is the measurement dimension ``m``
(SURVEY.md §2.3): each device holds a row block ``A_i`` of the operator
and the matching block of ``b``/residual, computes ``A_i x`` locally, and
the adjoint matvec ``Aᴴr = Σ_i A_iᴴ r_i`` is an all-reduce that XLA lowers
onto the device interconnect (NCCL over NVLink on GPUs).  Everything else in the solver — prox, stepsize logic, stopping
— is either elementwise on the replicated signal ``x`` or a scalar
reduction (⟨Δx,Δg⟩, ‖·‖², f-values) that the partitioner turns into a
``psum``; because the reduction is collective and deterministic, **every
device sees identical stepsize and stopping decisions** (the BASELINE.json
determinism requirement).

Two composable mechanisms, both driving the *same* solver:

  * ``shard_problem(problem, mesh)`` — GSPMD path: ``device_put`` each
    measurement-space leaf with a row ``NamedSharding`` and replicate the
    rest; jit + the XLA partitioner insert all collectives.  Idiomatic
    "annotate shardings, let XLA do the rest".
  * ``RowShardedDenseOp`` — explicit ``shard_map`` path: the matvec pair
    is written with hand-placed ``psum`` so collective placement is
    guaranteed by construction, not inferred.  Used by the multi-chip
    dry-run and available for cases where propagation needs pinning.

Multi-host: call ``jax.distributed.initialize()`` before building the
mesh from ``jax.devices()`` — the same code paths compile unchanged.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from .operators import DenseOp, LinearOp
from .problem import Problem

__all__ = [
    "make_mesh", "make_mesh_2d", "shard_problem", "shard_problem_2d",
    "RowShardedDenseOp", "RowShardedPlanarDenseOp", "ShardedCDPOp",
    "RowShardedSparseOp", "GridShardedDenseOp",
    "GridShardedSparseOp", "sharded_sparse_lstsq_gradmap_2d",
    "GridShardedPlanarDenseOp", "RowShardedTVDivOp",
    "replicate", "shard_rows",
    "shard_cols", "sharded_lstsq_gradmap", "sharded_lstsq_gradmap_2d",
    "sharded_planar_lstsq_gradmap_2d",
    "sharded_planar_phase_hinge_gradmap_2d",
    "sharded_phase_hinge_gradmap", "sharded_planar_phase_hinge_gradmap",
    "sharded_pointwise_gradmap", "sharded_cdp_phase_hinge_gradmap",
    "sharded_tv_lstsq_gradmap",
]


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "rows",
              devices=None) -> Mesh:
    """1-D device mesh over the measurement axis.  Uses all visible
    devices by default (pass ``n_devices`` to take a prefix)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(rows: int, cols: int,
                 row_axis: str = "rows", col_axis: str = "cols",
                 devices=None) -> Mesh:
    """2-D device mesh: measurement rows × signal columns (SURVEY.md
    §2.3 TP row — the layout for very wide problems where replicating x
    and A's column dimension on every device wastes memory)."""
    if devices is None:
        devices = jax.devices()
    if rows * cols > len(devices):
        raise ValueError(
            f"mesh {rows}x{cols} needs {rows*cols} devices, "
            f"have {len(devices)}")
    grid = np.asarray(devices[:rows * cols]).reshape(rows, cols)
    return Mesh(grid, (row_axis, col_axis))


def replicate(x, mesh: Mesh):
    """Place an array fully replicated on the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_rows(x, mesh: Mesh, axis_name: str = "rows"):
    """Shard an array's leading axis across the mesh axis."""
    x = jnp.asarray(x)
    spec = P(axis_name, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def shard_cols(x, mesh: Mesh, axis_name: str = "cols"):
    """Shard an array's LAST axis across the mesh axis (signal-space
    placement on a 2-D mesh: x, prox anchors, A's column dim)."""
    x = jnp.asarray(x)
    spec = P(*([None] * (x.ndim - 1)), axis_name)
    return jax.device_put(x, NamedSharding(mesh, spec))


@jax.tree_util.register_pytree_node_class
class RowShardedDenseOp(LinearOp):
    """Dense operator with explicit shard_map row parallelism.

    Forward: purely local GEMV on each device's row block (zero
    communication — the output inherits the row sharding).
    Adjoint:  local ``A_iᴴ y_i`` followed by one ``psum`` over the mesh
    axis — the single collective of the iteration.
    """

    def __init__(self, A, mesh: Mesh, axis_name: str = "rows",
                 precision=jax.lax.Precision.HIGHEST):
        self.A = A
        self.mesh = mesh
        self.axis_name = axis_name
        self.precision = precision

    def __call__(self, x):
        ax = self.axis_name
        prec = self.precision

        def fwd(A_blk, x_rep):
            return jnp.matmul(A_blk, x_rep, precision=prec)

        return shard_map(
            fwd, mesh=self.mesh,
            in_specs=(P(ax, None), P()),
            out_specs=P(ax),
        )(self.A, x)

    def rmatvec(self, y):
        ax = self.axis_name
        prec = self.precision

        def adj(A_blk, y_blk):
            return jax.lax.psum(
                jnp.matmul(A_blk.conj().T, y_blk, precision=prec), ax)

        return shard_map(
            adj, mesh=self.mesh,
            in_specs=(P(ax, None), P(ax)),
            out_specs=P(),
        )(self.A, y)

    @property
    def shape(self):
        return self.A.shape

    def tree_flatten(self):
        return (self.A,), (self.mesh, self.axis_name, self.precision)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)


@jax.tree_util.register_pytree_node_class
class RowShardedPlanarDenseOp(LinearOp):
    """Planar-complex dense operator (see operators.PlanarDenseOp) with
    explicit shard_map row parallelism — the flagship sharded layout:
    16k complex measurement rows split over the mesh, all-real local
    matmuls, one psum on the adjoint leg."""

    def __init__(self, Ar, Ai, mesh: Mesh, axis_name: str = "rows",
                 precision=jax.lax.Precision.HIGHEST):
        self.Ar = Ar
        self.Ai = Ai
        self.mesh = mesh
        self.axis_name = axis_name
        self.precision = precision

    def __call__(self, x):
        ax, prec = self.axis_name, self.precision

        def fwd(Ar_blk, Ai_blk, x_rep):
            p = jnp.matmul(Ar_blk, x_rep, precision=prec)
            q = jnp.matmul(Ai_blk, x_rep, precision=prec)
            return jnp.stack([p[:, 0] - q[:, 1], p[:, 1] + q[:, 0]],
                             axis=-1)

        return shard_map(
            fwd, mesh=self.mesh,
            in_specs=(P(ax, None), P(ax, None), P()),
            out_specs=P(ax),
        )(self.Ar, self.Ai, x)

    def rmatvec(self, y):
        ax, prec = self.axis_name, self.precision

        def adj(Ar_blk, Ai_blk, y_blk):
            p = jnp.matmul(Ar_blk.T, y_blk, precision=prec)
            q = jnp.matmul(Ai_blk.T, y_blk, precision=prec)
            out = jnp.stack([p[:, 0] + q[:, 1], p[:, 1] - q[:, 0]],
                            axis=-1)
            return jax.lax.psum(out, ax)

        return shard_map(
            adj, mesh=self.mesh,
            in_specs=(P(ax, None), P(ax, None), P(ax)),
            out_specs=P(),
        )(self.Ar, self.Ai, y)

    @property
    def shape(self):
        return self.Ar.shape

    def tree_flatten(self):
        return (self.Ar, self.Ai), (self.mesh, self.axis_name,
                                    self.precision)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def sharded_planar_phase_hinge_gradmap(op: "RowShardedPlanarDenseOp", b):
    """Fused sharded planar PhaseMax-hinge gradmap — the flagship
    complex 16k-row configuration in its all-real layout: one
    shard_map region per evaluation, one fused psum of (f, Aᴴ∇f)."""
    ax, prec = op.axis_name, op.precision

    def local(Ar_blk, Ai_blk, b_blk, x_rep):
        p = jnp.matmul(Ar_blk, x_rep, precision=prec)
        q = jnp.matmul(Ai_blk, x_rep, precision=prec)
        d_blk = jnp.stack([p[:, 0] - q[:, 1], p[:, 1] + q[:, 0]], axis=-1)
        mag = jnp.sqrt(jnp.sum(d_blk * d_blk, axis=-1))
        r = jnp.maximum(mag - b_blk, 0.0)
        f_part = 0.5 * jnp.sum(r * r)
        gl = (r / jnp.maximum(mag, 1e-30))[:, None] * d_blk
        gp = jnp.matmul(Ar_blk.T, gl, precision=prec)
        gq = jnp.matmul(Ai_blk.T, gl, precision=prec)
        g_part = jnp.stack([gp[:, 0] + gq[:, 1], gp[:, 1] - gq[:, 0]],
                           axis=-1)
        f, g = jax.lax.psum((f_part, g_part), ax)
        return d_blk, f, g

    fn = shard_map(local, mesh=op.mesh,
                   in_specs=(P(ax, None), P(ax, None), P(ax), P()),
                   out_specs=(P(ax), P(), P()))
    return lambda x: fn(op.Ar, op.Ai, b, x)


def sharded_pointwise_gradmap(op: "RowShardedDenseOp", loss_local,
                              *data_leaves):
    """Generic fused sharded gradmap for any POINTWISE smooth loss
    f(d) = Σᵢ ℓ(dᵢ; dataᵢ):  one shard_map region computing
    (d_blk, Σ_local ℓ, A_blkᴴ ℓ'(d_blk)) with a single fused psum.
    ``loss_local(d_blk, *data_blks) -> (loss_sum, dloss)`` runs on the
    device-local rows; every ``data_leaves`` array must carry the same
    row sharding as A (shard_problem guarantees this for smooth-term
    leaves).  Covers logistic, squared hinge, and any future pointwise
    loss without new collective code."""
    ax, prec = op.axis_name, op.precision
    nd = len(data_leaves)

    def local(A_blk, x_rep, *data_blks):
        d_blk = jnp.matmul(A_blk, x_rep, precision=prec)
        f_part, dloss = loss_local(d_blk, *data_blks)
        g_part = jnp.matmul(A_blk.conj().T, dloss, precision=prec)
        f, g = jax.lax.psum((f_part, g_part), ax)
        return d_blk, f, g

    fn = shard_map(local, mesh=op.mesh,
                   in_specs=(P(ax, None), P()) + (P(ax),) * nd,
                   out_specs=(P(ax), P(), P()))
    return lambda x: fn(op.A, x, *data_leaves)


def sharded_lstsq_gradmap(op: "RowShardedDenseOp", b):
    """Fused sharded least-squares gradmap:
    x ↦ (Ax, ½‖Ax−b‖², Aᴴ(Ax−b)) as ONE shard_map region per call —
    the entire measurement-space computation stays device-local and the
    only communication is a single fused psum of (f_partial, g_partial)
    over the mesh axis.  This is the optimal collective pattern for the
    row-sharded iteration (SURVEY.md §2.3): zero communication on the
    forward leg, one all-reduce on the adjoint leg.

    ``b`` must carry the same row sharding as ``op.A`` (shard_problem
    guarantees this).
    """
    ax = op.axis_name

    prec = op.precision

    def local(A_blk, b_blk, x_rep):
        d_blk = jnp.matmul(A_blk, x_rep, precision=prec)
        r = d_blk - b_blk
        f_part = 0.5 * jnp.real(jnp.vdot(r, r))
        g_part = jnp.matmul(A_blk.conj().T, r, precision=prec)
        f, g = jax.lax.psum((f_part, g_part), ax)
        return d_blk, f, g

    fn = shard_map(local, mesh=op.mesh,
                   in_specs=(P(ax, None), P(ax), P()),
                   out_specs=(P(ax), P(), P()))
    return lambda x: fn(op.A, b, x)


def sharded_phase_hinge_gradmap(op: "RowShardedDenseOp", b):
    """Fused sharded PhaseMax-hinge gradmap (the flagship complex
    16k-measurement config):  f(d)=½Σmax(|d|−b,0)² with Wirtinger
    gradient, evaluated shard-locally with one psum for (f, Aᴴ∇f)."""
    ax = op.axis_name

    prec = op.precision

    def local(A_blk, b_blk, x_rep):
        d_blk = jnp.matmul(A_blk, x_rep, precision=prec)
        mag = jnp.abs(d_blk)
        r = jnp.maximum(mag - b_blk, 0.0)
        f_part = 0.5 * jnp.sum(r * r)
        grad_local = (r / jnp.maximum(mag, 1e-30)) * d_blk
        g_part = jnp.matmul(A_blk.conj().T, grad_local, precision=prec)
        f, g = jax.lax.psum((f_part, g_part), ax)
        return d_blk, f, g

    fn = shard_map(local, mesh=op.mesh,
                   in_specs=(P(ax, None), P(ax), P()),
                   out_specs=(P(ax), P(), P()))
    return lambda x: fn(op.A, b, x)


@jax.tree_util.register_pytree_node_class
class ShardedCDPOp(LinearOp):
    """Coded-diffraction stack, sharded over the MASK axis:
    d_k = FFT(m_k ⊙ x), masks (K, n) with K split across the mesh.

    Forward: each device modulates the replicated x by its local masks
    and runs a BATCHED unitary FFT — zero communication (d inherits the
    mask-axis sharding).  Adjoint: local Σ_k conj(m_k) ⊙ IFFT(y_k)
    followed by one psum — the identical collective pattern as the dense
    row-sharded matvec, with FFTs instead of GEMVs.  Replaces the
    per-mask StackedOp(Compose(FFT, Diag)) composition of
    problems/phase_retrieval_cdp.py under ``shard_problem``.
    """

    def __init__(self, mods, wins, mesh: Mesh, axis_name: str = "rows"):
        self.mods = mods                   # (K, n) modulation masks m_k
        self.wins = wins                   # (K, n) FFT windows w_k
        self.mesh = mesh
        self.axis_name = axis_name

    def __call__(self, x):
        ax = self.axis_name

        def fwd(m_blk, w_blk, x_rep):
            return w_blk * jnp.fft.fft(m_blk * x_rep[None, :],
                                       norm="ortho")

        return shard_map(
            fwd, mesh=self.mesh,
            in_specs=(P(ax, None), P(ax, None), P()),
            out_specs=P(ax, None),
        )(self.mods, self.wins, x)

    def rmatvec(self, y):
        ax = self.axis_name

        def adj(m_blk, w_blk, y_blk):
            xs = jnp.conj(m_blk) * jnp.fft.ifft(
                jnp.conj(w_blk) * y_blk, norm="ortho")
            return jax.lax.psum(jnp.sum(xs, axis=0), ax)

        return shard_map(
            adj, mesh=self.mesh,
            in_specs=(P(ax, None), P(ax, None), P(ax, None)),
            out_specs=P(),
        )(self.mods, self.wins, y)

    @property
    def shape(self):
        K, n = self.mods.shape
        return (K * n, n)

    def tree_flatten(self):
        return (self.mods, self.wins), (self.mesh, self.axis_name)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def sharded_cdp_phase_hinge_gradmap(op: "ShardedCDPOp", b):
    """Fused sharded PhaseMax-hinge gradmap for the coded-diffraction
    operator: one shard_map region per evaluation — batched local FFT,
    local hinge, batched local IFFT-adjoint, single fused psum of
    (f, Aᴴ∇f).  ``b`` is (K, n) magnitudes sharded like the masks."""
    ax = op.axis_name

    def local(m_blk, w_blk, b_blk, x_rep):
        d_blk = w_blk * jnp.fft.fft(m_blk * x_rep[None, :], norm="ortho")
        mag = jnp.abs(d_blk)
        r = jnp.maximum(mag - b_blk, 0.0)
        f_part = 0.5 * jnp.sum(r * r)
        gl = (r / jnp.maximum(mag, 1e-30)) * d_blk
        g_part = jnp.sum(jnp.conj(m_blk) * jnp.fft.ifft(
            jnp.conj(w_blk) * gl, norm="ortho"), axis=0)
        f, g = jax.lax.psum((f_part, g_part), ax)
        return d_blk, f, g

    fn = shard_map(local, mesh=op.mesh,
                   in_specs=(P(ax, None), P(ax, None), P(ax, None), P()),
                   out_specs=(P(ax, None), P(), P()))
    return lambda x: fn(op.mods, op.wins, b, x)


@jax.tree_util.register_pytree_node_class
class RowShardedSparseOp(LinearOp):
    """Sparse operator row-sharded as per-device BCOO blocks.

    The scipy matrix is split into equal row blocks at placement time;
    each block's (data, indices) are nnz-padded to the max block nnz
    (padding entries carry zero data at row 0 — exact no-ops) and
    stacked on a leading device axis, so shard_map sees plain dense
    carrier arrays.  Forward: local BCOO matvec (zero communication);
    adjoint: local Aᵢᵀ yᵢ + one psum — the same collective pattern as
    the dense row-sharded operator.
    """

    def __init__(self, data, indices, block_rows: int, n: int,
                 mesh: Mesh, axis_name: str = "rows"):
        self.data = data               # (D, nnz_pad)
        self.indices = indices         # (D, nnz_pad, 2) int32
        self.block_rows = block_rows
        self.n = n
        self.mesh = mesh
        self.axis_name = axis_name

    @classmethod
    def from_bcoo(cls, M, mesh: Mesh, axis_name: str = "rows"):
        """Split an existing BCOO (operators.SparseOp payload) into the
        per-device block representation (host-side placement op)."""
        import numpy as onp
        import scipy.sparse as sp
        data = onp.asarray(M.data)
        idx = onp.asarray(M.indices)
        coo = sp.coo_matrix((data, (idx[:, 0], idx[:, 1])), shape=M.shape)
        return cls.from_scipy(coo, mesh, axis_name)

    @classmethod
    def from_scipy(cls, sp_matrix, mesh: Mesh, axis_name: str = "rows",
                   dtype=None):
        import numpy as onp
        sp_matrix = sp_matrix.tocsr()
        if dtype is not None:
            sp_matrix = sp_matrix.astype(onp.dtype(dtype))
        m, n = sp_matrix.shape
        D = mesh.devices.size
        if m % D != 0:
            raise ValueError(f"row count {m} not divisible by mesh {D}")
        br = m // D
        blocks = [sp_matrix[i * br:(i + 1) * br].tocoo() for i in range(D)]
        nnz_pad = max(max(blk.nnz for blk in blocks), 1)
        data = onp.zeros((D, nnz_pad), sp_matrix.dtype)
        indices = onp.zeros((D, nnz_pad, 2), onp.int32)
        for i, blk in enumerate(blocks):
            data[i, :blk.nnz] = blk.data
            indices[i, :blk.nnz, 0] = blk.row
            indices[i, :blk.nnz, 1] = blk.col
        return cls(shard_rows(data, mesh, axis_name),
                   shard_rows(indices, mesh, axis_name), br, n,
                   mesh, axis_name)

    def _local_bcoo(self, data_blk, indices_blk):
        from jax.experimental import sparse as jsparse
        return jsparse.BCOO((data_blk[0], indices_blk[0]),
                            shape=(self.block_rows, self.n))

    def __call__(self, x):
        ax = self.axis_name

        def fwd(data_blk, indices_blk, x_rep):
            return self._local_bcoo(data_blk, indices_blk) @ x_rep

        return shard_map(
            fwd, mesh=self.mesh,
            in_specs=(P(ax, None), P(ax, None, None), P()),
            out_specs=P(ax),
        )(self.data, self.indices, x)

    def rmatvec(self, y):
        ax = self.axis_name

        def adj(data_blk, indices_blk, y_blk):
            A_blk = self._local_bcoo(data_blk, indices_blk)
            return jax.lax.psum(A_blk.T @ y_blk, ax)

        return shard_map(
            adj, mesh=self.mesh,
            in_specs=(P(ax, None), P(ax, None, None), P(ax)),
            out_specs=P(),
        )(self.data, self.indices, y)

    @property
    def shape(self):
        return (self.data.shape[0] * self.block_rows, self.n)

    def tree_flatten(self):
        return (self.data, self.indices), (self.block_rows, self.n,
                                           self.mesh, self.axis_name)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


@jax.tree_util.register_pytree_node_class
class GridShardedDenseOp(LinearOp):
    """Dense operator on a 2-D (rows × cols) mesh — SURVEY.md §2.3's
    wide-problem layout: A is grid-sharded, x/signal-space vectors are
    COLUMN-sharded, b/measurement-space vectors row-sharded.

    Forward: local (m/R × n/C) GEMV + psum over the col axis → d row-
    sharded, replicated over cols.  Adjoint: local Aᴴ GEMV + psum over
    the row axis → g col-sharded.  One all-reduce per leg, each riding
    a single mesh axis.
    """

    def __init__(self, A, mesh: Mesh, row_axis: str = "rows",
                 col_axis: str = "cols",
                 precision=jax.lax.Precision.HIGHEST):
        self.A = A
        self.mesh = mesh
        self.row_axis = row_axis
        self.col_axis = col_axis
        self.precision = precision

    def __call__(self, x):
        rx, cx, prec_ = self.row_axis, self.col_axis, self.precision

        def fwd(A_blk, x_blk):
            return jax.lax.psum(
                jnp.matmul(A_blk, x_blk, precision=prec_), cx)

        return shard_map(
            fwd, mesh=self.mesh,
            in_specs=(P(rx, cx), P(cx)),
            out_specs=P(rx),
        )(self.A, x)

    def rmatvec(self, y):
        rx, cx, prec_ = self.row_axis, self.col_axis, self.precision

        def adj(A_blk, y_blk):
            return jax.lax.psum(
                jnp.matmul(A_blk.conj().T, y_blk, precision=prec_), rx)

        return shard_map(
            adj, mesh=self.mesh,
            in_specs=(P(rx, cx), P(rx)),
            out_specs=P(cx),
        )(self.A, y)

    @property
    def shape(self):
        return self.A.shape

    def tree_flatten(self):
        return (self.A,), (self.mesh, self.row_axis, self.col_axis,
                           self.precision)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)


def sharded_lstsq_gradmap_2d(op: "GridShardedDenseOp", b):
    """Fused least-squares gradmap on the 2-D mesh: one shard_map region
    computing (d, f, g) with exactly TWO all-reduces — a psum over the
    col axis for d = Ax and one fused psum over the row axis for
    (f, Aᴴr).  f partials are computed from the col-replicated d block,
    so they are summed over rows only (a both-axes psum would count
    every column replica)."""
    rx, cx, prec_ = op.row_axis, op.col_axis, op.precision

    def local(A_blk, b_blk, x_blk):
        d_blk = jax.lax.psum(
            jnp.matmul(A_blk, x_blk, precision=prec_), cx)
        r = d_blk - b_blk
        f_part = 0.5 * jnp.real(jnp.vdot(r, r))
        g_part = jnp.matmul(A_blk.conj().T, r, precision=prec_)
        # g: sum over row axis (col-sharded result); f: rows only —
        # fused into one collective over the row axis.
        f, g = jax.lax.psum((f_part, g_part), rx)
        return d_blk, f, g

    fn = shard_map(local, mesh=op.mesh,
                   in_specs=(P(rx, cx), P(rx), P(cx)),
                   out_specs=(P(rx), P(), P(cx)))
    return lambda x: fn(op.A, b, x)


@jax.tree_util.register_pytree_node_class
class GridShardedSparseOp(LinearOp):
    """Sparse operator on the 2-D (rows × cols) wide-problem mesh —
    the BCOO analog of :class:`GridShardedDenseOp`.

    The scipy matrix is split into an R×C grid of blocks at placement
    time; each block's (data, indices) are nnz-padded to the global max
    block nnz (pad entries carry zero data at local (0,0) — exact
    no-ops) and stacked on leading (R, C) device axes, so shard_map
    sees plain dense carrier arrays grid-sharded like A itself.
    Forward: local (m/R × n/C) BCOO matvec + psum over the col axis →
    d row-sharded; adjoint: local Aᵢⱼᵀ yᵢ + psum over the row axis →
    g col-sharded.  One all-reduce per leg, each riding a single mesh
    axis — the identical collective budget to the dense 2-D operator.
    """

    def __init__(self, data, indices, block_rows: int, block_cols: int,
                 mesh: Mesh, row_axis: str = "rows",
                 col_axis: str = "cols"):
        self.data = data               # (R, C, nnz_pad)
        self.indices = indices         # (R, C, nnz_pad, 2) int32, local
        self.block_rows = block_rows
        self.block_cols = block_cols
        self.mesh = mesh
        self.row_axis = row_axis
        self.col_axis = col_axis

    @classmethod
    def from_scipy(cls, sp_matrix, mesh: Mesh, row_axis: str = "rows",
                   col_axis: str = "cols", dtype=None):
        import numpy as onp
        sp_matrix = sp_matrix.tocsr()
        if dtype is not None:
            sp_matrix = sp_matrix.astype(onp.dtype(dtype))
        m, n = sp_matrix.shape
        R = mesh.shape[row_axis]
        C = mesh.shape[col_axis]
        if m % R != 0 or n % C != 0:
            raise ValueError(f"sparse {m}x{n} not divisible by mesh "
                             f"{R}x{C}")
        br, bc = m // R, n // C
        blocks = [[sp_matrix[i * br:(i + 1) * br,
                             j * bc:(j + 1) * bc].tocoo()
                   for j in range(C)] for i in range(R)]
        nnz_pad = max(max(b.nnz for row in blocks for b in row), 1)
        data = onp.zeros((R, C, nnz_pad), sp_matrix.dtype)
        indices = onp.zeros((R, C, nnz_pad, 2), onp.int32)
        for i in range(R):
            for j in range(C):
                blk = blocks[i][j]
                data[i, j, :blk.nnz] = blk.data
                indices[i, j, :blk.nnz, 0] = blk.row
                indices[i, j, :blk.nnz, 1] = blk.col
        grid = NamedSharding(mesh, P(row_axis, col_axis, None))
        grid4 = NamedSharding(mesh, P(row_axis, col_axis, None, None))
        return cls(jax.device_put(jnp.asarray(data), grid),
                   jax.device_put(jnp.asarray(indices), grid4),
                   br, bc, mesh, row_axis, col_axis)

    @classmethod
    def from_bcoo(cls, M, mesh: Mesh, row_axis: str = "rows",
                  col_axis: str = "cols"):
        import numpy as onp
        import scipy.sparse as sp
        data = onp.asarray(M.data)
        idx = onp.asarray(M.indices)
        coo = sp.coo_matrix((data, (idx[:, 0], idx[:, 1])), shape=M.shape)
        return cls.from_scipy(coo, mesh, row_axis, col_axis)

    def _local_bcoo(self, data_blk, indices_blk):
        from jax.experimental import sparse as jsparse
        return jsparse.BCOO((data_blk[0, 0], indices_blk[0, 0]),
                            shape=(self.block_rows, self.block_cols))

    def __call__(self, x):
        rx, cx = self.row_axis, self.col_axis

        def fwd(data_blk, indices_blk, x_blk):
            d = self._local_bcoo(data_blk, indices_blk) @ x_blk
            return jax.lax.psum(d, cx)

        return shard_map(
            fwd, mesh=self.mesh,
            in_specs=(P(rx, cx, None), P(rx, cx, None, None), P(cx)),
            out_specs=P(rx),
        )(self.data, self.indices, x)

    def rmatvec(self, y):
        rx, cx = self.row_axis, self.col_axis

        def adj(data_blk, indices_blk, y_blk):
            g = self._local_bcoo(data_blk, indices_blk).T @ y_blk
            return jax.lax.psum(g, rx)

        return shard_map(
            adj, mesh=self.mesh,
            in_specs=(P(rx, cx, None), P(rx, cx, None, None), P(rx)),
            out_specs=P(cx),
        )(self.data, self.indices, y)

    @property
    def shape(self):
        return (self.data.shape[0] * self.block_rows,
                self.data.shape[1] * self.block_cols)

    def tree_flatten(self):
        return (self.data, self.indices), (
            self.block_rows, self.block_cols, self.mesh,
            self.row_axis, self.col_axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def sharded_sparse_lstsq_gradmap_2d(op: "GridShardedSparseOp", b):
    """Fused least-squares gradmap on the sparse 2-D mesh — the exact
    collective budget of :func:`sharded_lstsq_gradmap_2d`: one psum
    over cols for d, one fused psum over rows for (f, g)."""
    rx, cx = op.row_axis, op.col_axis

    def local(data_blk, indices_blk, b_blk, x_blk):
        A_blk = op._local_bcoo(data_blk, indices_blk)
        d_blk = jax.lax.psum(A_blk @ x_blk, cx)
        r = d_blk - b_blk
        f_part = 0.5 * jnp.real(jnp.vdot(r, r))
        g_part = A_blk.T @ r
        f, g = jax.lax.psum((f_part, g_part), rx)
        return d_blk, f, g

    fn = shard_map(local, mesh=op.mesh,
                   in_specs=(P(rx, cx, None), P(rx, cx, None, None),
                             P(rx), P(cx)),
                   out_specs=(P(rx), P(), P(cx)))
    return lambda x: fn(op.data, op.indices, b, x)


def _planar_combine_fwd(p, q):
    """(Ar x, Ai x) → planar product  d = [pr − qi, pi + qr]."""
    return jnp.stack([p[:, 0] - q[:, 1], p[:, 1] + q[:, 0]], axis=-1)


def _planar_combine_adj(p, q):
    """(Arᵀ y, Aiᵀ y) → conjugate adjoint  g = [pr + qi, pi − qr]."""
    return jnp.stack([p[:, 0] + q[:, 1], p[:, 1] - q[:, 0]], axis=-1)


@jax.tree_util.register_pytree_node_class
class GridShardedPlanarDenseOp(LinearOp):
    """Planar-complex dense operator on the 2-D (rows × cols) mesh — the
    wide-problem layout for the flagship complex dtype (round-2 VERDICT
    missing #5): both channel matrices (Ar, Ai) are grid-sharded, planar
    signal vectors x ∈ ℝ^{n×2} are sharded on their LEADING (signal)
    axis over cols, planar measurement vectors on rows.

    Forward: two local (m/R × n/C)·(n/C × 2) GEMMs, the planar combine,
    one psum over the col axis.  Adjoint: two local transposed GEMMs,
    conjugate combine, one psum over the row axis — identical collective
    budget to the real :class:`GridShardedDenseOp` (one all-reduce per
    leg, each over one mesh axis); the channel count doubles
    local FLOPs, not communication.
    """

    def __init__(self, Ar, Ai, mesh: Mesh, row_axis: str = "rows",
                 col_axis: str = "cols",
                 precision=jax.lax.Precision.HIGHEST):
        self.Ar = Ar
        self.Ai = Ai
        self.mesh = mesh
        self.row_axis = row_axis
        self.col_axis = col_axis
        self.precision = precision

    def __call__(self, x):
        rx, cx, prec_ = self.row_axis, self.col_axis, self.precision

        def fwd(Ar_blk, Ai_blk, x_blk):
            p = jnp.matmul(Ar_blk, x_blk, precision=prec_)
            q = jnp.matmul(Ai_blk, x_blk, precision=prec_)
            return jax.lax.psum(_planar_combine_fwd(p, q), cx)

        return shard_map(
            fwd, mesh=self.mesh,
            in_specs=(P(rx, cx), P(rx, cx), P(cx, None)),
            out_specs=P(rx, None),
        )(self.Ar, self.Ai, x)

    def rmatvec(self, y):
        rx, cx, prec_ = self.row_axis, self.col_axis, self.precision

        def adj(Ar_blk, Ai_blk, y_blk):
            p = jnp.matmul(Ar_blk.T, y_blk, precision=prec_)
            q = jnp.matmul(Ai_blk.T, y_blk, precision=prec_)
            return jax.lax.psum(_planar_combine_adj(p, q), rx)

        return shard_map(
            adj, mesh=self.mesh,
            in_specs=(P(rx, cx), P(rx, cx), P(rx, None)),
            out_specs=P(cx, None),
        )(self.Ar, self.Ai, y)

    @property
    def shape(self):
        return self.Ar.shape

    def tree_flatten(self):
        return (self.Ar, self.Ai), (self.mesh, self.row_axis,
                                    self.col_axis, self.precision)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def _sharded_planar_gradmap_2d(op: "GridShardedPlanarDenseOp",
                               loss_local, data):
    """Shared 2-D-mesh fused planar gradmap: one shard_map region with
    exactly TWO all-reduces — the col-axis psum assembling d and one
    fused row-axis psum carrying (f, g).  ``loss_local(d_blk, *data) →
    (Σℓ over the local rows, ∂ℓ/∂d elementwise (mb,2))``; f partials
    come from the col-replicated d block, so they sum over rows only."""
    rx, cx, prec_ = op.row_axis, op.col_axis, op.precision

    def local(Ar_blk, Ai_blk, x_blk, *data_blks):
        p = jnp.matmul(Ar_blk, x_blk, precision=prec_)
        q = jnp.matmul(Ai_blk, x_blk, precision=prec_)
        d_blk = jax.lax.psum(_planar_combine_fwd(p, q), cx)
        f_part, ell = loss_local(d_blk, *data_blks)
        pr = jnp.matmul(Ar_blk.T, ell, precision=prec_)
        qr = jnp.matmul(Ai_blk.T, ell, precision=prec_)
        g_part = _planar_combine_adj(pr, qr)
        f, g = jax.lax.psum((f_part, g_part), rx)
        return d_blk, f, g

    data_specs = tuple(
        P(rx, *([None] * (jnp.ndim(v) - 1))) for v in data)
    fn = shard_map(local, mesh=op.mesh,
                   in_specs=(P(rx, cx), P(rx, cx), P(cx, None))
                   + data_specs,
                   out_specs=(P(rx, None), P(), P(cx, None)))
    return lambda x: fn(op.Ar, op.Ai, x, *data)


def sharded_planar_lstsq_gradmap_2d(op: "GridShardedPlanarDenseOp", b):
    """Fused planar least-squares gradmap on the 2-D mesh (b planar
    (m,2), row-sharded)."""
    def loss(d_blk, b_blk):
        r = d_blk - b_blk
        return 0.5 * jnp.sum(r * r), r
    return _sharded_planar_gradmap_2d(op, loss, (b,))


def sharded_planar_phase_hinge_gradmap_2d(op: "GridShardedPlanarDenseOp",
                                          b):
    """Fused PhaseMax-hinge gradmap on the 2-D mesh (b real (m,)
    magnitudes, row-sharded) — the flagship §3.4 layout gets the
    wide-problem mesh."""
    def loss(d_blk, b_blk):
        mag = jnp.sqrt(jnp.sum(d_blk * d_blk, axis=-1))
        r = jnp.maximum(mag - b_blk, 0.0)
        s = r / jnp.maximum(mag, 1e-30)
        return 0.5 * jnp.sum(r * r), s[:, None] * d_blk
    return _sharded_planar_gradmap_2d(op, loss, (b,))


@jax.tree_util.register_pytree_node_class
class RowShardedTVDivOp(LinearOp):
    """TV-dual operator ``c·div`` with the DUAL FIELD itself sharded over
    image rows — structured-operator (stencil) parallelism via halo
    exchange.

    Layout: the dual field p (2, H, W) is sharded on the H axis; images
    (H, W) on their leading axis.  The forward-difference stencils need
    exactly ONE neighbor row per leg, exchanged with a single
    ``lax.ppermute`` to the neighbouring device:

      * forward  ``c·div(p)`` reads pv[i−1] → each device sends its LAST
        vertical-dual row to the next device (device 0 receives the
        ppermute zero-fill, which IS the Neumann boundary term);
      * adjoint  ``c·grad(y)`` reads y[i+1] → each device sends its FIRST
        row to the previous device (last device's zero-fill again matches
        the boundary).

    Stencil semantics bit-match ``operators.TVDiv2D``/``TVGrad2D`` (the
    oracle's ``tv_div_2d``/``tv_grad_2d``): the globally-last dual row /
    gradient row is zeroed on the owning device via ``lax.axis_index``.
    Unlike the dense row-sharded layout (signal replicated), here the
    VARIABLE is distributed — memory for p, y, x, Δx scales 1/D — and the
    solver's scalar reductions over p partition into psums.
    """

    def __init__(self, c: float, mesh: Mesh, axis_name: str = "rows"):
        self.c = c
        self.mesh = mesh
        self.axis_name = axis_name

    def _nd(self):
        return int(self.mesh.shape[self.axis_name])

    def _fwd_local(self, p_blk):
        """Device-local c·div of a (2, Hb, W) block; one ppermute."""
        ax, D, c = self.axis_name, self._nd(), self.c
        pv, ph = p_blk[0], p_blk[1]
        # halo: previous device's last pv row (device 0 gets zeros)
        prev_last = jax.lax.ppermute(
            pv[-1:, :], ax, [(i, i + 1) for i in range(D - 1)])
        pv_shift = jnp.concatenate([prev_last, pv[:-1, :]], axis=0)
        # pv with the GLOBAL last row zeroed (only on the last device)
        is_last = (jax.lax.axis_index(ax) == D - 1)
        tail = jnp.where(is_last, jnp.zeros_like(pv[-1:, :]), pv[-1:, :])
        pv_m = jnp.concatenate([pv[:-1, :], tail], axis=0)
        out = pv_shift - pv_m
        zcol = jnp.zeros((ph.shape[0], 1), p_blk.dtype)
        out = out + (jnp.concatenate([zcol, ph[:, :-1]], axis=1)
                     - jnp.concatenate([ph[:, :-1], zcol], axis=1))
        return c * out

    def _adj_local(self, y_blk):
        """Device-local c·grad of a (Hb, W) block; one ppermute."""
        ax, D, c = self.axis_name, self._nd(), self.c
        # halo: next device's first row (last device gets zeros)
        nxt_first = jax.lax.ppermute(
            y_blk[:1, :], ax, [(i, i - 1) for i in range(1, D)])
        y_down = jnp.concatenate([y_blk[1:, :], nxt_first], axis=0)
        dv = y_down - y_blk
        # global last gradient row is zero (Neumann): on the last device
        # y_down's tail is the ppermute zero-fill, not x[H] — overwrite.
        is_last = (jax.lax.axis_index(ax) == D - 1)
        tail = jnp.where(is_last, jnp.zeros_like(dv[-1:, :]), dv[-1:, :])
        dv = jnp.concatenate([dv[:-1, :], tail], axis=0)
        dh = jnp.concatenate(
            [y_blk[:, 1:] - y_blk[:, :-1],
             jnp.zeros((y_blk.shape[0], 1), y_blk.dtype)], axis=1)
        return c * jnp.stack([dv, dh])

    def __call__(self, p):
        ax = self.axis_name
        return shard_map(
            self._fwd_local, mesh=self.mesh,
            in_specs=(P(None, ax, None),),
            out_specs=P(ax, None),
        )(p)

    def rmatvec(self, y):
        ax = self.axis_name
        return shard_map(
            self._adj_local, mesh=self.mesh,
            in_specs=(P(ax, None),),
            out_specs=P(None, ax, None),
        )(y)

    def tree_flatten(self):
        return (), (self.c, self.mesh, self.axis_name)

    @classmethod
    def tree_unflatten(cls, aux, children):
        del children
        return cls(*aux)


def sharded_tv_lstsq_gradmap(op: "RowShardedTVDivOp", b):
    """Fused sharded TV-dual gradmap:
    p ↦ (c·div p, ½‖c·div p − b‖², c·grad(c·div p − b)) as ONE shard_map
    region — two halo ppermutes (one per stencil leg) and a single psum
    for the f-value; d, the residual, and g stay row-local end to end.
    ``b`` must carry the image row sharding (shard_problem places it)."""
    ax = op.axis_name

    def local(b_blk, p_blk):
        d_blk = op._fwd_local(p_blk)
        r = d_blk - b_blk
        f = jax.lax.psum(0.5 * jnp.vdot(r, r).real, ax)
        g_blk = op._adj_local(r)
        return d_blk, f, g_blk

    fn = shard_map(local, mesh=op.mesh,
                   in_specs=(P(ax, None), P(None, ax, None)),
                   out_specs=(P(ax, None), P(), P(None, ax, None)))
    return lambda p: fn(b, p)


def shard_problem_2d(problem: Problem, mesh: Mesh,
                     row_axis: str = "rows",
                     col_axis: str = "cols") -> Problem:
    """Place a dense problem on a 2-D (rows × cols) mesh — the
    wide-problem layout (SURVEY.md:126): A grid-sharded, measurement-
    space leaves row-sharded, SIGNAL-space leaves (x0, prox anchors)
    column-sharded, so neither x nor A's column dimension is replicated.
    The matvec pair runs through :class:`GridShardedDenseOp` (one psum
    per mesh axis per leg); the solver's elementwise prox runs sharded
    on the col axis and scalar reductions psum over it.  Planar-complex
    problems (:class:`~fasta_tpu.operators.PlanarDenseOp`) take the same
    layout via :class:`GridShardedPlanarDenseOp`: both channel matrices
    grid-sharded, planar signal vectors (n,2) sharded on their signal
    axis over cols.  Sparse problems
    (:class:`~fasta_tpu.operators.SparseOp`) take it via
    :class:`GridShardedSparseOp` (grid-blocked BCOO carriers, same
    one-psum-per-leg budget)."""
    from .operators import PlanarDenseOp, SparseOp
    planar = isinstance(problem.op, PlanarDenseOp)
    sparse = isinstance(problem.op, SparseOp)
    if not planar and not sparse and not isinstance(problem.op, DenseOp):
        raise TypeError("shard_problem_2d supports DenseOp, "
                        "PlanarDenseOp and SparseOp problems "
                        f"(got {type(problem.op).__name__})")
    if sparse:
        m, n = problem.op.shape
    else:
        A = jnp.asarray(problem.op.Ar if planar else problem.op.A)
        m, n = A.shape
    R = mesh.shape[row_axis]
    C = mesh.shape[col_axis]
    if m % R != 0 or n % C != 0:
        raise ValueError(
            f"problem {m}x{n} not divisible by mesh {R}x{C}")

    def place(x, space: str):
        if not isinstance(x, (jax.Array, np.ndarray)):
            return x
        x = jnp.asarray(x)
        if space == "m" and x.ndim >= 1 and x.shape[0] == m:
            return jax.device_put(x, NamedSharding(
                mesh, P(row_axis, *([None] * (x.ndim - 1)))))
        if space == "n":
            if planar and x.ndim == 2 and x.shape == (n, 2):
                # planar signal vector: shard the SIGNAL axis (leading)
                return jax.device_put(
                    x, NamedSharding(mesh, P(col_axis, None)))
            if not planar and x.ndim >= 1 and x.shape[-1] == n:
                return shard_cols(x, mesh, col_axis)
        return replicate(x, mesh)

    fterm = jax.tree_util.tree_map(lambda l: place(l, "m"), problem.fterm)
    gterm = jax.tree_util.tree_map(lambda l: place(l, "n"), problem.gterm)
    x0 = place(problem.x0, "n")
    if sparse:
        op = GridShardedSparseOp.from_bcoo(problem.op.M, mesh,
                                           row_axis, col_axis)
        return problem.with_parts(op=op, fterm=fterm, gterm=gterm,
                                  x0=x0,
                                  name=problem.name + f"@{R}x{C}dev")
    grid_spec = NamedSharding(mesh, P(row_axis, col_axis))
    if planar:
        op = GridShardedPlanarDenseOp(
            jax.device_put(A, grid_spec),
            jax.device_put(jnp.asarray(problem.op.Ai), grid_spec),
            mesh, row_axis, col_axis, precision=problem.op.precision)
    else:
        op = GridShardedDenseOp(jax.device_put(A, grid_spec), mesh,
                                row_axis, col_axis,
                                precision=problem.op.precision)
    return problem.with_parts(op=op, fterm=fterm, gterm=gterm, x0=x0,
                              name=problem.name + f"@{R}x{C}dev")


def _measurement_dim(problem: Problem) -> Optional[int]:
    """Leading dimension of the measurement space d = A x."""
    try:
        d_shape = jax.eval_shape(problem.op, jnp.asarray(problem.x0)).shape
    except Exception:
        return None
    return d_shape[0] if d_shape else None


def shard_problem(problem: Problem, mesh: Mesh,
                  axis_name: str = "rows",
                  explicit: bool = True) -> Problem:
    """Place a problem on the mesh, row-sharded over measurements.

    Placement rule: any array leaf of the operator or smooth term whose
    leading dimension equals the measurement dimension ``m`` is sharded
    ``P(axis, None, …)``; every other leaf (prox-term anchors, x0 — all
    signal-space) is replicated.  With ``explicit=True`` (the default)
    a DenseOp is additionally wrapped in :class:`RowShardedDenseOp` so
    the matvec collectives are hand-placed via shard_map — guaranteed
    partitioned execution with exactly one psum on the adjoint leg (and,
    for least-squares / phase-hinge smooth terms, a single fused
    shard-local gradmap region per iteration).  ``explicit=False``
    leaves collective placement to the XLA partitioner (GSPMD) — correct
    everywhere, but some backends (notably CPU) choose to replicate.

    The measurement dim must divide the mesh size for an even layout;
    uneven sizes still work (XLA pads internally) but waste the remainder
    devices' tail.
    """
    m = _measurement_dim(problem)
    n_dev = mesh.devices.size
    if m is not None and m % n_dev != 0:
        raise ValueError(
            f"measurement dim {m} not divisible by mesh size {n_dev}; "
            f"pad the problem or choose a different mesh")

    def place(x, shard_ok: bool):
        if not isinstance(x, (jax.Array, np.ndarray)):
            return x
        x = jnp.asarray(x)
        if shard_ok and x.ndim >= 1 and m is not None and x.shape[0] == m:
            return shard_rows(x, mesh, axis_name)
        return replicate(x, mesh)

    op = jax.tree_util.tree_map(lambda l: place(l, True), problem.op)
    fterm = jax.tree_util.tree_map(lambda l: place(l, True), problem.fterm)
    gterm = jax.tree_util.tree_map(lambda l: place(l, False), problem.gterm)
    x0 = place(problem.x0, False)

    from .operators import (ComposeOp, DiagonalOp, MaskedFourierOp,
                            PlanarDenseOp, ScaledOp, SparseOp, StackedOp,
                            TVDiv2D)
    if explicit and isinstance(op, ScaledOp) and isinstance(op.op, TVDiv2D):
        # stencil (structured-operator) parallelism: shard the dual
        # field itself over image rows; halo exchange via ppermute
        x0 = jnp.asarray(problem.x0)
        if x0.ndim != 3 or x0.shape[1] % n_dev != 0:
            raise ValueError(
                f"TV dual field {x0.shape} needs H divisible by mesh "
                f"size {n_dev}")
        x0 = jax.device_put(
            x0, NamedSharding(mesh, P(None, axis_name, None)))
        op = RowShardedTVDivOp(float(op.c), mesh, axis_name)
    elif explicit and isinstance(op, DenseOp):
        op = RowShardedDenseOp(op.A, mesh, axis_name,
                               precision=op.precision)
    elif explicit and isinstance(op, PlanarDenseOp):
        op = RowShardedPlanarDenseOp(op.Ar, op.Ai, mesh, axis_name,
                                     precision=op.precision)
    elif explicit and isinstance(op, SparseOp):
        op = RowShardedSparseOp.from_bcoo(op.M, mesh, axis_name)
    elif (explicit and isinstance(op, StackedOp)
          and all(isinstance(member, ComposeOp)
                  and isinstance(member.outer, MaskedFourierOp)
                  and isinstance(member.inner, DiagonalOp)
                  for member in op.ops)):
        # coded-diffraction stack: shard over the mask axis (the K
        # member ops collapse into batched (K, n) mask arrays)
        mods = jnp.stack([member.inner.d for member in op.ops])
        wins = jnp.stack([member.outer.mask for member in op.ops])
        if mods.shape[0] % n_dev != 0:
            raise ValueError(
                f"CDP mask count {mods.shape[0]} not divisible by "
                f"mesh size {n_dev}")
        op = ShardedCDPOp(shard_rows(mods, mesh, axis_name),
                          shard_rows(wins, mesh, axis_name),
                          mesh, axis_name)

    return problem.with_parts(op=op, fterm=fterm, gterm=gterm, x0=x0,
                              name=problem.name + f"@{n_dev}dev")
