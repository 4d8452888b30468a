"""3D partitioning: batch parallelism x Hilbert-ordered data parallelism.

Implements the paper's Sec. III-A (the planning half of the reference's
``core/partition.py``, byte for byte in what it builds):

  * slices along the rotation axis are *batch*-parallel (no communication;
    they share the system matrix ``A``);
  * each slice is *data*-parallel: tomogram voxels and sinogram rays are
    Hilbert-ordered (``core.hilbert``) and cut into ``P_d`` equal contiguous
    chunks;
  * each device's sparse shard is compiled into a static **blocked-ELL**
    layout consumed by the SpMM kernel: rows are grouped into
    row-blocks of ``R`` rows; every row-block is processed in ``S`` stages;
    a stage consumes ``K`` nnz slots per row and stages a *window* of at
    most ``BUF`` unique input columns into shared memory (the paper's
    multi-stage 3D input buffering, Sec. III-B4).

Per-nnz storage is 4 bytes -- int16 window index + fp16 length -- matching
the paper's ``{unsigned short ind; half len;}`` packing (Sec. III-C2).

The partial outputs of a device cover only a *band* of the
(Hilbert-ordered) output rows; :func:`build_sparse_exchange` and
:func:`build_hier_sparse_exchange` turn the bands into the static tables
of the footprint exchange in ``dist.collectives`` (paper Fig. 6-7).

A plan is pure numpy: :func:`plan_to_arrays` / :func:`plan_from_arrays`
carry one across as a flat ``{name: ndarray}`` dict (what weights are to
a model, the plan is to this system).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math

import numpy as np
import scipy.sparse as sp

from .geometry import XCTGeometry, build_system_matrix
from .hilbert import tile_hilbert_order

__all__ = [
    "PartitionConfig",
    "OperatorShards",
    "Plan",
    "ShapeSpec",
    "build_plan",
    "estimate_plan",
    "build_sparse_exchange",
    "build_hier_sparse_exchange",
    "default_socket",
    "estimate_hier_sparse",
    "exchange_volume_params",
    "hier_sparse_wire_bytes",
    "plan_from_arrays",
    "plan_key",
    "plan_to_arrays",
    "socket_chunk_layout",
]


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Static knobs of the decomposition + kernel layout."""

    n_data: int = 1  # P_d: in-slice data-parallel devices
    tile: int = 8  # Hilbert patch side (cells)
    rows_per_block: int = 32  # R: kernel row-block height
    nnz_per_stage: int = 32  # K: nnz slots per row per stage
    index_dtype: type = np.int16  # window index (2 bytes, paper packing)
    value_dtype: type = np.float16  # stored lengths (2 bytes, paper packing)
    # Hilbert-aware socket assignment: with ``socket=G > 1``, device slot
    # ``p = f * n_slow + t`` (fast-axis-major, the runtime linearization)
    # owns Hilbert chunk ``t * G + f`` instead of chunk ``p`` -- every
    # socket holds G *consecutive* Hilbert chunks, so its members' band
    # footprints overlap and ``build_hier_sparse_exchange``'s merged-band
    # dedup actually bites.  Must equal the topology's fast-level size
    # (or 1 for the legacy identity layout).
    socket: int = 1
    # Window slot assignment (docs/architecture.md "Slot reordering"):
    #   "runs"        (default) stage membership by run-extension over the
    #                 row-block's sorted column union -- each stage's
    #                 window is a *contiguous* chunk of the union, so
    #                 winmap entries form long consecutive-source runs and
    #                 the coalesced DMA path issues few large copies;
    #   "first_seen"  the legacy CSR-position layout (stage = slot index
    #                 // K), kept as the A/B baseline: stage windows
    #                 sample strided chunks of every row, fragmenting the
    #                 union (92% length-1 segments at bench scale).
    slot_order: str = "runs"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """The shape and dtype of an array that is not allocated: the leaves
    of :func:`estimate_plan`'s operators (the reference uses
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: np.dtype

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        object.__setattr__(self, "dtype", np.dtype(self.dtype))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass
class OperatorShards:
    """Blocked-ELL shards for one operator (A or A^T), stacked over devices.

    Rows are packed as *virtual rows*: a matrix row with more nnz than
    ``S * K`` slots is split across several virtual rows (its partials are
    summed by the output scatter-add), and virtual rows are packed densely
    into blocks of ``R``.  This keeps ELL padding at the ceil-rounding
    level (~1.2x nnz) instead of max-row-driven (measured 5-7x), and
    avoids empty rows entirely even though the footprint of a subdomain is
    a scattered O(1/sqrt(P_d)) subset of the (Hilbert-ordered) output rows
    (EXPERIMENTS.md §Perf XCT iteration: "row splitting").

    Shapes (P = n_data, B = virtual-row blocks, S = stages, R = rows/block,
    K = nnz slots/row/stage, BUF = window entries/stage):

      inds       [P, B, S, R, K]  window-local column index (int16)
      vals       [P, B, S, R, K]  intersection lengths (float32 master copy;
                                  cast to the precision policy's storage
                                  dtype at apply time)
      winmap     [P, B, S, BUF]   device-local input column ids to stage
                                  (int32: BUF-padded, scalar-prefetched to
                                  SMEM by the fused kernel, which DMAs the
                                  named rows HBM -> VMEM itself -- no
                                  staged window tensor exists in HBM)
      winsegs    [P, B, S, NSEG, 3]  run-length DMA segments
                                  ``{src_start, dst_start, len}`` from
                                  ``kernels.ops.winmap_segments``, sorted
                                  by descending copy length (``kernels.
                                  ops.sort_segments_by_class``): the
                                  slot reordering keeps source runs
                                  long, so the fused kernel's default
                                  coalesced path issues one strided copy
                                  per segment instead of one per row
      segoff     [P, B, S, NCLS+1]  per-length-class segment offsets into
                                  the sorted ``winsegs`` table: the
                                  kernel loops each power-of-two class
                                  over exactly its own slots (dynamic
                                  ``fori_loop`` bounds), so window DMA
                                  issue work is O(real segments), not
                                  O(classes x capacity)
      row_map    [P, B, R]        global (padded) output row of each
                                  virtual row; padding points at
                                  ``n_rows_pad`` (dropped by the scatter);
                                  duplicates (split rows) are summed
      foot_rows  list[P] of int64 arrays -- global rows with nnz per device
                                  (host-side only; drives exchange tables
                                  and the Table-IV volume accounting)
    """

    inds: np.ndarray
    vals: np.ndarray
    winmap: np.ndarray
    row_map: np.ndarray
    foot_rows: list
    n_rows_pad: int  # padded global output rows (multiple of P * chunk)
    n_cols_pad: int  # padded global input cols (multiple of P * chunk)
    rows_per_dev: int  # output ownership chunk
    cols_per_dev: int  # input ownership chunk
    nnz: int  # true nnz across devices (before padding)
    winsegs: np.ndarray | None = None  # [P, B, S, NSEG, 3] DMA segments
    segoff: np.ndarray | None = None  # [P, B, S, NCLS+1] class offsets

    @property
    def flat_rows(self) -> int:
        """Rows in the concatenated occupied-block space (B * R)."""
        return self.inds.shape[1] * self.inds.shape[3]

    @property
    def padded_nnz(self) -> int:
        return int(np.prod(self.inds.shape))

    def hbm_bytes(
        self, value_bytes: int | None = 2, index_bytes: int = 2
    ) -> int:
        """Resident HBM footprint of the operator (paper packed layout).

        Counts only what actually lives in HBM under in-kernel staging:
        the packed nnz slots plus the int32 ``winmap``/``row_map``
        metadata.  The staged ``[B, S, BUF, F]`` window tensor of the
        legacy gather path is a *transient*, not part of the operator --
        and the fused kernel never allocates it at all (its staging is
        the shared-memory ring, see ``kernels.xct_spmm.smem_bytes``).

        ``value_bytes=None`` reads the width off ``vals`` itself (the
        shards normally hold the f32 master copy, so pass the policy's
        ``vals_bytes`` to price the packed form; ``None`` is for shards
        already stored narrow).  A 1-byte width adds the per-(block,
        stage) int32 dequantization-scale table the quantized tier
        carries alongside the values.
        """
        vb = (
            self.vals.dtype.itemsize if value_bytes is None else value_bytes
        )
        # quantized tier: one int32 exponent per (device, block, stage)
        scale_table = (
            int(np.prod(self.inds.shape[:3])) * 4 if vb == 1 else 0
        )
        segs = 0 if self.winsegs is None else self.winsegs.size
        offs = 0 if self.segoff is None else self.segoff.size
        return self.padded_nnz * (vb + index_bytes) + (
            self.winmap.size * 4
            + self.row_map.size * 4
            + segs * 4
            + offs * 4
            + scale_table
        )


@dataclasses.dataclass
class Plan:
    """Full per-volume partition plan (both operators + orderings).

    ``row_pos`` / ``col_pos`` map a padded *Hilbert* index to its
    *stored* (device-major) index when the socket-aware chunk layout is
    active (``cfg.socket > 1``): stored block ``p`` holds Hilbert chunk
    ``socket_chunk_layout(P, socket)[p]``.  ``None`` means identity
    (chunk ``p`` on device slot ``p``).
    """

    geo: XCTGeometry
    cfg: PartitionConfig
    row_perm: np.ndarray  # curve position -> flat sinogram cell
    col_perm: np.ndarray  # curve position -> flat voxel
    proj: OperatorShards  # rows = sinogram, cols = tomogram
    back: OperatorShards  # rows = tomogram, cols = sinogram
    row_pos: np.ndarray | None = None  # Hilbert idx -> stored idx (sino)
    col_pos: np.ndarray | None = None  # Hilbert idx -> stored idx (tomo)

    @property
    def n_data(self) -> int:
        return self.cfg.n_data


def _pad_to(x: int, m: int) -> int:
    return m * int(math.ceil(x / m))


def socket_chunk_layout(p_data: int, socket: int) -> np.ndarray:
    """``sigma[p]`` = Hilbert chunk owned by device slot ``p``.

    The runtime linearizes device slots fast-axis-major
    (``p = f * n_slow + t``, as ``jax.lax.axis_index(data_axes)`` does
    with the fast axis first), so under the identity layout socket ``t``
    owns chunks ``{t, n_slow + t, ...}`` -- *scattered* along the
    Hilbert curve, leaving the hier-sparse socket dedup little overlap
    (ROADMAP: "consecutive chunks currently land in different sockets").
    With ``sigma[f * n_slow + t] = t * G + f`` every socket owns ``G``
    consecutive chunks: adjacent subdomains whose band footprints shadow
    each other (paper Fig. 6-7).
    """
    if socket <= 1:
        return np.arange(p_data)
    if p_data % socket:
        raise ValueError(
            f"socket {socket} does not divide P_d={p_data}"
        )
    n_slow = p_data // socket
    p = np.arange(p_data)
    return (p % n_slow) * socket + p // n_slow


def _block_positions(sigma: np.ndarray, chunk: int) -> np.ndarray:
    """Padded Hilbert index -> stored index under chunk layout ``sigma``
    (stored block ``p`` holds Hilbert chunk ``sigma[p]``)."""
    inv = np.empty_like(sigma)
    inv[sigma] = np.arange(sigma.size)
    i = np.arange(sigma.size * chunk)
    return inv[i // chunk] * chunk + i % chunk


SLOT_ORDERS = ("runs", "first_seen")


def _runs_stage_assignment(
    cols: np.ndarray,
    blk: np.ndarray,
    vrow: np.ndarray,
    j_in_vrow: np.ndarray,
    n_virt: int,
    S: int,
    K: int,
    n_cols_pad: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Run-extension slot assignment for one device's nnz entries.

    Instead of the legacy CSR-position split (stage ``s`` takes slots
    ``[s*K, (s+1)*K)`` of every row, so each stage's window samples a
    *strided* subset of the row-block's columns), partition each
    row-block's sorted column union U into ``S`` equal contiguous chunks
    and let stage ``s`` own chunk ``s``.  Every stage window is then a
    contiguous slice of U, so consecutive winmap entries extend into
    long runs -- the coalesced DMA path's whole win
    (docs/architecture.md "Slot reordering").

    Per-row feasibility (a row may have more than ``K`` columns inside
    one chunk) is restored by a staircase repair on each virtual row's
    cumulative stage counts ``t[0..S]``: clamp forward
    ``t[s] <= t[s-1] + K`` then backward ``t[s] >= t[s+1] - K`` -- both
    passes keep ``t`` monotone with gaps <= K, and total nnz <= S*K per
    virtual row guarantees a feasible staircase.  Stage membership stays
    monotone along each row's sorted column order, so windows remain
    sorted and ELL slots fill densely from 0 within each stage.
    """
    if S == 1:
        return np.zeros_like(j_in_vrow), j_in_vrow
    # sorted unique columns per row-block (U), via one global unique
    bkey = blk * np.int64(n_cols_pad) + cols
    ub = np.unique(bkey)
    ub_blk = ub // n_cols_pad
    ub_col = ub % n_cols_pad
    n_blk = int(blk.max()) + 1
    cnt_b = np.bincount(ub_blk, minlength=n_blk)
    start_b = np.concatenate(([0], np.cumsum(cnt_b)[:-1]))
    # chunk boundaries: beta[b, s-1] = first column of block b's chunk s
    bidx = start_b[:, None] + (
        np.arange(1, S, dtype=np.int64) * cnt_b[:, None]
    ) // S
    beta = ub_col[bidx]  # [n_blk, S-1]
    nat = (cols[:, None] >= beta[blk]).sum(axis=1)  # natural stage
    # per-virtual-row staircase repair on cumulative counts
    counts = np.bincount(
        vrow * np.int64(S) + nat, minlength=n_virt * S
    ).reshape(n_virt, S)
    t = np.zeros((n_virt, S + 1), np.int64)
    np.cumsum(counts, axis=1, out=t[:, 1:])
    for s in range(1, S):
        np.minimum(t[:, s], t[:, s - 1] + K, out=t[:, s])
    for s in range(S - 1, 0, -1):
        np.maximum(t[:, s], t[:, s + 1] - K, out=t[:, s])
    stage = (j_in_vrow[:, None] >= t[vrow, 1:S]).sum(axis=1)
    slot = j_in_vrow - t[vrow, stage]
    return stage, slot


def _build_operator(
    a_perm: sp.csr_matrix,
    cfg: PartitionConfig,
    rows_per_dev: int,
    cols_per_dev: int,
) -> OperatorShards:
    """Compile a (row+col Hilbert-permuted) sparse matrix into blocked-ELL.

    Fully vectorized: per device, every nnz entry is assigned a destination
    (block, stage, row-in-block, slot) and a window-local column index in
    O(nnz log nnz) NumPy, no per-row Python loops.

    ``rows_per_dev`` / ``cols_per_dev`` are dictated by the plan so that the
    tomogram (x) and sinogram (y) vector spaces are *shared* between A and
    A^T -- CG hands one operator's output chunk straight to the other.
    """
    if cfg.slot_order not in SLOT_ORDERS:
        raise ValueError(
            f"unknown slot_order {cfg.slot_order!r}; one of {SLOT_ORDERS}"
        )
    P = cfg.n_data
    R, K = cfg.rows_per_block, cfg.nnz_per_stage
    n_rows, n_cols = a_perm.shape
    n_cols_pad = cols_per_dev * P
    n_rows_pad = rows_per_dev * P
    assert n_cols_pad >= n_cols and n_rows_pad >= n_rows

    a_csc = a_perm.tocsc()

    # --- pass 1: per-device virtual-row assignment; global B and S --------
    # S covers the mean row load (x1.35 headroom); rows needing more than
    # S*K slots are split into several virtual rows (partials summed by
    # the output scatter-add); virtual rows pack densely into R-blocks.
    per_dev: list[sp.csr_matrix] = []
    foot_rows: list[np.ndarray] = []  # per device: rows with nnz
    max_blocks = 1
    s_global = 1
    for p in range(P):
        c0, c1 = p * cols_per_dev, min((p + 1) * cols_per_dev, n_cols)
        sub = a_csc[:, c0:c1].tocsr()
        sub.sort_indices()
        per_dev.append(sub)
        nz_rows = np.flatnonzero(np.diff(sub.indptr))
        foot_rows.append(nz_rows.astype(np.int64))
        if nz_rows.size == 0:
            continue
        row_nnz = np.diff(sub.indptr)
        mean_nnz = row_nnz[nz_rows].mean()
        s_global = max(
            s_global, int(math.ceil(1.35 * mean_nnz / K))
        )
    S = s_global
    cap = S * K  # slots per virtual row

    staged = []
    for p in range(P):
        sub = per_dev[p]
        row_nnz = np.diff(sub.indptr)
        n_virt = int(np.ceil(row_nnz / cap).sum())
        max_blocks = max(max_blocks, int(math.ceil(n_virt / R)))
        staged.append(None)
    B = _pad_to(max(1, max_blocks), 8)

    # --- pass 2: per-device entry destinations + window construction ------
    # For each nnz: (block, stage, virtual-row-in-block, slot) destination,
    # plus the window-local column index obtained by grouping (block,
    # stage) and deduplicating columns inside each group.
    buf = 8
    nnz = 0
    for p in range(P):
        sub = per_dev[p]
        indptr, cols, data = sub.indptr, sub.indices, sub.data
        m = data.size
        nnz += int(m)
        if m == 0:
            continue
        row_of = np.repeat(
            np.arange(n_rows, dtype=np.int64), np.diff(indptr)
        )
        pos = np.arange(m, dtype=np.int64) - indptr[row_of]
        virt = pos // cap  # split index within the row
        # dense virtual-row ids: rank of (row, virt) among unique pairs
        vkey = row_of * np.int64(n_rows + 1) + virt
        uv, vrow = np.unique(vkey, return_inverse=True)
        blk = vrow // R
        ri = vrow % R
        j_in_vrow = pos % cap  # nnz rank within its virtual row
        if cfg.slot_order == "first_seen":
            # legacy CSR-position layout: stage windows sample strided
            # position chunks of every row (A/B baseline, fragmented)
            stage = j_in_vrow // K
            slot = j_in_vrow % K
        else:
            stage, slot = _runs_stage_assignment(
                cols, blk, vrow, j_in_vrow, uv.size, S, K, n_cols_pad
            )
        group = blk * S + stage  # [0, B*S)
        key = group * np.int64(n_cols_pad) + cols
        uk, inv = np.unique(key, return_inverse=True)
        ug = uk // n_cols_pad
        uc = uk % n_cols_pad
        gstart = np.searchsorted(ug, np.arange(B * S, dtype=np.int64))
        local = np.arange(uk.size, dtype=np.int64) - gstart[ug]
        buf = max(buf, int((local + 1).max()))
        staged[p] = (group, ri, slot, data, inv, ug, uc, local, uv)
    buf = _pad_to(buf, 8)
    assert buf < 32768, f"window {buf} overflows int16 index"

    # --- pass 3: materialize ---------------------------------------------
    inds = np.zeros((P, B, S, R, K), dtype=cfg.index_dtype)
    vals = np.zeros((P, B, S, R, K), dtype=np.float32)
    if cfg.slot_order == "first_seen":
        # legacy pad encoding: unused window slots read row 0, each its
        # own length-1 copy (kept bit-for-bit as the A/B baseline)
        winmap = np.zeros((P, B, S, buf), dtype=np.int32)
    else:
        # pad-slot encoding: initialize every window to arange so the
        # unused tail of a stage window (slots sz..buf-1) reads rows
        # sz..buf-1 -- one consecutive-source run (O(log buf) DMA
        # pieces) instead of buf-sz length-1 copies of row 0.  Safe:
        # buf <= cols_per_dev (asserted), so every pad source row
        # exists in the local slab.
        assert buf <= cols_per_dev, (buf, cols_per_dev)
        winmap = np.broadcast_to(
            np.arange(buf, dtype=np.int32), (P, B, S, buf)
        ).copy()
    row_map = np.full((P, B, R), n_rows_pad, dtype=np.int32)
    for p in range(P):
        if staged[p] is None:
            continue
        group, ri, slot, data, inv, ug, uc, local, uv = staged[p]
        flat_iv = inds[p].reshape(B * S, R, K)
        flat_vv = vals[p].reshape(B * S, R, K)
        flat_iv[group, ri, slot] = local[inv].astype(cfg.index_dtype)
        flat_vv[group, ri, slot] = data
        winmap[p].reshape(B * S, buf)[ug, local] = uc
        vrows = (uv // np.int64(n_rows + 1)).astype(np.int32)
        row_map[p].reshape(-1)[: vrows.size] = vrows

    from ..kernels.ops import sort_segments_by_class, winmap_segments

    # run-length coalesced DMA plan for the fused kernel's default path:
    # one strided copy per segment, the table sorted by length class so
    # the kernel loops each class over exactly its own slots
    winsegs, segoff = sort_segments_by_class(winmap_segments(winmap), buf)
    return OperatorShards(
        inds=inds,
        vals=vals,
        winmap=winmap,
        row_map=row_map,
        foot_rows=foot_rows,
        n_rows_pad=n_rows_pad,
        n_cols_pad=n_cols_pad,
        rows_per_dev=rows_per_dev,
        cols_per_dev=cols_per_dev,
        nnz=nnz,
        winsegs=winsegs,
        segoff=segoff,
    )


def build_plan(
    geo: XCTGeometry,
    cfg: PartitionConfig,
    a: sp.csr_matrix | None = None,
) -> Plan:
    """Build the full partition plan for one scan geometry.

    ``a`` may be passed in to reuse a prebuilt system matrix (memoization
    across precision policies in benchmarks).
    """
    if a is None:
        a = build_system_matrix(geo)
    # Hilbert orderings for both domains (paper Fig. 4a: square patches).
    col_perm, _ = tile_hilbert_order(geo.n, geo.n, cfg.tile)
    row_perm, _ = tile_hilbert_order(geo.n_angles, geo.num_det, cfg.tile)
    a_perm = a[row_perm][:, col_perm].tocsr()
    # Shared vector-space chunking: tomogram chunk serves as proj input and
    # back output; sinogram chunk as proj output and back input.
    P, R = cfg.n_data, cfg.rows_per_block
    align = max(8, R)
    tomo_chunk = _pad_to(int(math.ceil(geo.n_vox / P)), align)
    sino_chunk = _pad_to(int(math.ceil(geo.n_rays / P)), align)
    # Socket-aware chunk layout: relabel both vector spaces device-major
    # (stored block p = Hilbert chunk sigma[p]) so every downstream
    # consumer -- exchange tables, dense reduce-scatter ownership, the
    # shards themselves -- keeps its identity owner = index // chunk
    # arithmetic while sockets end up holding consecutive Hilbert chunks.
    sigma = socket_chunk_layout(P, cfg.socket)
    if cfg.socket > 1:
        row_pos = _block_positions(sigma, sino_chunk)
        col_pos = _block_positions(sigma, tomo_chunk)
        coo = a_perm.tocoo()
        a_dev = sp.csr_matrix(
            (coo.data, (row_pos[coo.row], col_pos[coo.col])),
            shape=(sino_chunk * P, tomo_chunk * P),
        )
    else:
        row_pos = col_pos = None
        a_dev = a_perm
    proj = _build_operator(a_dev, cfg, sino_chunk, tomo_chunk)
    back = _build_operator(a_dev.T.tocsr(), cfg, tomo_chunk, sino_chunk)
    return Plan(
        geo=geo, cfg=cfg, row_perm=row_perm, col_perm=col_perm,
        proj=proj, back=back, row_pos=row_pos, col_pos=col_pos,
    )


def estimate_plan(geo: XCTGeometry, cfg: PartitionConfig) -> Plan:
    """Analytic shard-shape estimation for budget planning at full scale.

    Returns a Plan whose OperatorShards carry :class:`ShapeSpec` leaves
    (no allocation, no system-matrix build -- Brain-scale nnz is
    ~7e11).  Geometry model (the reference's constants, calibrated
    against real plans at n in [64, 256]):

      * footprint rows/device ~ 1.8 * n_rows / sqrt(P)   (sqrt2 shadow x
        ~1.27 Hilbert-scatter/imbalance margin)
      * max per-device row nnz ~ min(1.45 n, 2.4 n / sqrt(P))  (proj);
        for A^T rows are voxels: ~ min(1.3 K, 2.4 * 1.3 K / sqrt(P))
      * window BUF ~ 6 (R + K), pair volume V ~ 2.5 * foot / P
    """
    from ..kernels.traffic import est_segments_per_stage
    from ..kernels.xct_spmm import _dma_classes

    P, R, K = cfg.n_data, cfg.rows_per_block, cfg.nnz_per_stage
    align = max(8, R)
    tomo_chunk = _pad_to(int(math.ceil(geo.n_vox / P)), align)
    sino_chunk = _pad_to(int(math.ceil(geo.n_rays / P)), align)
    nnz_total = geo.n_rays * 1.195 * geo.n
    sqrt_p = math.sqrt(P)

    def one(n_rows, n_cols, rows_per_dev, cols_per_dev):
        foot = min(n_rows, int(1.8 * n_rows / sqrt_p) + R)
        mean_nnz = nnz_total / P / max(foot, 1)
        s = max(1, int(math.ceil(1.35 * mean_nnz / K)))
        # virtual rows: one per footprint row plus splits for fat rows,
        # ~1.2x slot utilization headroom
        vrows = int(1.2 * max(foot, nnz_total / P / (s * K)))
        b = _pad_to(max(1, int(math.ceil(vrows / R))), 8)
        buf = _pad_to(min(6 * (R + K), R * K), 8)
        nseg = _pad_to(
            est_segments_per_stage(buf, slot_order=cfg.slot_order), 8
        )
        v = _pad_to(max(8, int(2.5 * vrows / P)), 8)
        op = OperatorShards(
            inds=ShapeSpec((P, b, s, R, K), np.int16),
            vals=ShapeSpec((P, b, s, R, K), np.float32),
            winmap=ShapeSpec((P, b, s, buf), np.int32),
            winsegs=ShapeSpec((P, b, s, nseg, 3), np.int32),
            segoff=ShapeSpec((P, b, s, len(_dma_classes(buf)) + 1),
                             np.int32),
            row_map=ShapeSpec((P, b, R), np.int32),
            foot_rows=None,
            n_rows_pad=rows_per_dev * P,
            n_cols_pad=cols_per_dev * P,
            rows_per_dev=rows_per_dev,
            cols_per_dev=cols_per_dev,
            nnz=int(nnz_total),
        )
        op.est_v = v  # type: ignore[attr-defined]
        op.est_foot = foot  # type: ignore[attr-defined]
        # chunk layout marker: lets estimate_hier_sparse pick the
        # adjacent-chunk union model for socket-aware plans
        op.est_socket = cfg.socket  # type: ignore[attr-defined]
        return op

    proj = one(geo.n_rays, geo.n_vox, sino_chunk, tomo_chunk)
    back = one(geo.n_vox, geo.n_rays, tomo_chunk, sino_chunk)
    return Plan(
        geo=geo, cfg=cfg, row_perm=None, col_perm=None,
        proj=proj, back=back,
    )


def build_sparse_exchange(
    op: OperatorShards,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Static index tables for the footprint-compressed exchange.

    For every (sender p, receiver q) pair, the virtual-row slots of p
    whose global row lands in q's owned chunk (split rows contribute one
    entry per virtual row; the receiver scatter-add sums them).  Padding:
    send indices point at the appended zero row (``flat_rows``), receive
    indices at the trash row (``rows_per_dev``) -- see
    ``dist.collectives.sparse_exchange``.

    Returns ``(send_idx [P,P,V], recv_idx [P,P,V], V)``.
    """
    P = op.inds.shape[0]
    rpd = op.rows_per_dev
    counts = np.zeros((P, P), dtype=np.int64)
    pair_rows: dict[tuple[int, int], tuple] = {}
    for p in range(P):
        rm = op.row_map[p].reshape(-1)  # [B*R] global row per vrow slot
        flat = np.flatnonzero(rm < op.n_rows_pad)
        if flat.size == 0:
            continue
        rows = rm[flat].astype(np.int64)
        owner = rows // rpd
        order = np.argsort(owner, kind="stable")
        rows_s, flat_s, owner_s = rows[order], flat[order], owner[order]
        uq, start = np.unique(owner_s, return_index=True)
        bounds = np.append(start, owner_s.size)
        for i, q in enumerate(uq):
            sel = slice(bounds[i], bounds[i + 1])
            pair_rows[(p, int(q))] = (rows_s[sel], flat_s[sel])
            counts[p, q] = bounds[i + 1] - bounds[i]
    v = _pad_to(max(1, int(counts.max())), 8)
    flat_rows = op.flat_rows
    send = np.full((P, P, v), flat_rows, dtype=np.int32)
    recv = np.full((P, P, v), rpd, dtype=np.int32)
    for (p, q), (rows, flat) in pair_rows.items():
        send[p, q, : rows.size] = flat
        recv[q, p, : rows.size] = rows - q * rpd
    return send, recv, v


def build_hier_sparse_exchange(
    op: OperatorShards, fast: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Static tables for the *hierarchical* footprint exchange
    (plan mode ``hier-sparse``).

    Devices are linearized fast-axis-major (``p = f * n_slow + t``, the
    rank order of ``dist.topology``): a *socket* ``t`` is the group of
    ``G = fast`` devices that share the fast link.  Socket members' band
    footprints overlap (paper Fig. 6-7: nearby Hilbert chunks shadow the
    same output rows), so instead of every member shipping its own copy
    across the slow links (flat ``sparse``), the socket first merges:

      stage 1   every member scatter-adds its band into the socket's
                *merged band* -- the union of member footprints, laid out
                grouped by the owner device's fast index ``f`` and padded
                to ``W`` rows per group -- and a reduce-scatter over the
                fast axis leaves member ``f`` holding group ``f``, fully
                summed within the socket (the dedup: overlapping rows
                cross the fast link once instead of the slow link
                ``G`` times);
      stage 2   member ``f``'s group contains exactly the rows owned by
                devices ``(f, t')``, so one sparse all-to-all over the
                *slow* axes delivers every row straight to its owner --
                no post-exchange intra-socket routing;
      stage 3   the owner scatter-adds received slots into its chunk.

    Returns ``(socket_map [P, flat_rows], send2 [P, n_slow, V2],
    recv2 [P, n_slow, V2], W, V2)``:

      socket_map  merged-band slot per local band slot (trash = G*W)
      send2       per slow peer, slots of my W-group to ship (pad = W)
      recv2       owned-chunk row per incoming slot (pad = rows_per_dev)
    """
    P = op.inds.shape[0]
    if P % fast:
        raise ValueError(f"fast size {fast} does not divide P={P}")
    G, n_slow = fast, P // fast
    rpd = op.rows_per_dev
    # per-device valid (band slot, global row) from the virtual-row map
    dev_slots, dev_rows = [], []
    for p in range(P):
        rm = op.row_map[p].reshape(-1)
        sl = np.flatnonzero(rm < op.n_rows_pad)
        dev_slots.append(sl)
        dev_rows.append(rm[sl].astype(np.int64))

    # merged band per socket: union of member rows, grouped by the owner's
    # fast index (monotone in row, so the union stays sorted per group)
    sockets = []  # per t: (uniq_rows, owner_fast, group_starts)
    w = 1
    for t in range(n_slow):
        allr = np.concatenate(
            [dev_rows[f * n_slow + t] for f in range(G)]
        )
        uniq = np.unique(allr)
        owner_f = (uniq // rpd) // n_slow
        counts = np.bincount(owner_f, minlength=G)
        w = max(w, int(counts.max()))
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        sockets.append((uniq, owner_f, starts))
    w = _pad_to(w, 8)

    flat_rows = op.flat_rows
    socket_map = np.full((P, flat_rows), G * w, dtype=np.int32)
    for p in range(P):
        t = p % n_slow
        uniq, owner_f, starts = sockets[t]
        if dev_rows[p].size == 0:
            continue
        i = np.searchsorted(uniq, dev_rows[p])
        socket_map[p, dev_slots[p]] = (
            owner_f[i] * w + (i - starts[owner_f[i]])
        ).astype(np.int32)

    # stage 2: per (socket t, fast f), the W-group rows split by the
    # owner's slow index; sender (f, t) block t' pairs with receiver
    # (f, t') block t
    v2 = 1
    group_rows: dict[tuple[int, int], list] = {}
    for t in range(n_slow):
        uniq, owner_f, starts = sockets[t]
        for f in range(G):
            rows = uniq[owner_f == f]  # W-group of member (f, t), sorted
            owner_t = (rows // rpd) % n_slow
            per_peer = [
                (np.flatnonzero(owner_t == t2), rows[owner_t == t2])
                for t2 in range(n_slow)
            ]
            group_rows[(f, t)] = per_peer
            if per_peer:
                v2 = max(v2, max(w_.size for w_, _ in per_peer))
    v2 = _pad_to(v2, 8)

    send2 = np.full((P, n_slow, v2), w, dtype=np.int32)
    recv2 = np.full((P, n_slow, v2), rpd, dtype=np.int32)
    for p in range(P):
        f, t = p // n_slow, p % n_slow
        for t2, (slots, rows) in enumerate(group_rows[(f, t)]):
            send2[p, t2, : slots.size] = slots
            q = f * n_slow + t2  # receiver of this block
            recv2[q, t, : rows.size] = rows - q * rpd
    return socket_map, send2, recv2, w, v2


def estimate_hier_sparse(
    op: OperatorShards,
    fast: int,
    n_slow: int,
    *,
    socket_aware: bool | None = None,
) -> tuple[int, int]:
    """Estimated ``(W, V2)`` for abstract plans (no tables built).

    Two union models, selected by the plan's chunk layout:

      * legacy scattered layout (``PartitionConfig(socket=1)``): socket
        members' footprints are independent draws of ``est_foot`` rows
        from the padded row space, so the merged band is
        ``R * (1 - (1 - foot/R)^G)`` rows;
      * socket-aware layout (``socket=G``; the default the reference's
        dry-run sweep picked): members own *G
        consecutive* Hilbert chunks, i.e. one contiguous subdomain
        covering ``1/n_slow`` of the curve, so the union follows the
        same sqrt shadow law as a single subdomain's footprint:
        ``min(R, 1.9 * R / sqrt(n_slow))``.  The constant is calibrated
        against measured ``build_hier_sparse_exchange`` tables at
        n in [32, 64] (est/real W in [0.9, 1.6], as the reference
        package's partition tests pin it) the same way ``estimate_plan``'s
        constants were.  At xct-brain scale the adjacent model is ~2.3x
        tighter than the independent-draw union (which overstates W for
        socket-aware plans).

    ``socket_aware=None`` infers the layout from the operator's
    ``est_socket`` attribute (attached by :func:`estimate_plan` from
    ``cfg.socket``).
    ``V2`` carries the usual ~1.6x imbalance margin over the even split
    of a W-group across slow peers.
    """
    rows = float(op.n_rows_pad)
    foot = float(getattr(op, "est_foot", 0.0)) or 1.8 * rows / math.sqrt(
        max(1, fast * n_slow)
    )
    if socket_aware is None:
        socket_aware = fast > 1 and getattr(op, "est_socket", 1) == fast
    if socket_aware:
        union = max(
            foot, min(rows, 1.9 * rows / math.sqrt(max(1, n_slow)))
        )
    else:
        union = rows * (1.0 - (1.0 - min(1.0, foot / rows)) ** fast)
    w = _pad_to(max(8, int(math.ceil(union / fast))), 8)
    v2 = _pad_to(max(8, int(1.6 * w / max(1, n_slow))), 8)
    return w, v2


def hier_sparse_wire_bytes(
    v2: int,
    n_slow: int,
    f: int,
    *,
    comm_bytes: int = 2,
    wire: str = "native",
) -> int:
    """Per-device DCI payload of one hier-sparse slow-axis all-to-all.

    ``native`` ships the partial sums in the policy's wire dtype:
    ``n_slow * V2 * F * comm_bytes``.  ``q8`` ships int8 values plus one
    f32 inverse scale per (slow peer, fused slice) -- the per-band
    compression ``dist.collectives.sparse_exchange(wire="q8")`` applies
    around the all-to-all:

    >>> hier_sparse_wire_bytes(1024, 4, 16, comm_bytes=2)
    131072
    >>> hier_sparse_wire_bytes(1024, 4, 16, comm_bytes=2, wire="q8")
    65792
    >>> _ / 131072  # doctest: +ELLIPSIS
    0.501953125
    """
    if wire == "native":
        return n_slow * v2 * f * comm_bytes
    if wire == "q8":
        return n_slow * v2 * f * 1 + n_slow * f * 4
    raise ValueError(f"unknown wire {wire!r}; one of ('native', 'q8')")


def default_socket(p_data: int, fast: int) -> int:
    """The socket layout a driver should use for a ``fast``-wide ladder.

    The ROADMAP's dry-run sweep at xct-brain scale
    (``launch.dryrun.socket_sweep``: socket=1 vs socket=fast-size at
    P_d = 512) picked the socket-aware layout -- consecutive Hilbert
    chunks per socket shrink the hier-sparse merged band, strictly
    reducing modeled DCI.  So: ``fast`` whenever it legally divides the
    device count, else the legacy scattered layout.
    """
    return fast if fast > 1 and p_data % fast == 0 else 1


def _key_scalar(v):
    """Canonicalize one fingerprint value (see :func:`plan_key`)."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        # repr round-trips doubles exactly; 1.0 and 1 must not collide
        # with each other across runs, so floats keep a "f:" tag
        return f"f:{v!r}"
    if isinstance(v, type) or isinstance(v, np.dtype):
        return np.dtype(v).name  # np.int16 / "int16" / dtype -> one name
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {
            f.name: _key_scalar(getattr(v, f.name))
            for f in dataclasses.fields(v)
        }
    raise TypeError(
        f"plan_key cannot fingerprint {type(v).__name__}: {v!r} "
        "(pass scalars, dtypes, or dataclasses of those)"
    )


def plan_key(
    geo: XCTGeometry, cfg: PartitionConfig = PartitionConfig(), **runtime
) -> str:
    """Stable fingerprint of everything that shapes a compiled plan.

    Two jobs share a cold path -- partition + winseg build + kernel
    compile -- exactly when they agree on (a) the scan geometry, (b) the
    decomposition/block layout (``PartitionConfig``: P_d, tile, R, K,
    the index/value dtype packing, socket layout) and (c) whichever
    runtime knobs the caller folds in (a serving layer passes the full
    ``ReconConfig``: precision ladder, comm mode, fuse, staging/DMA
    mode).  ``plan_key`` hashes all of it into one short stable string
    so a plan cache can amortize the cold path across jobs.  It gives
    the reference package's key for the same inputs.

    Properties a plan cache relies on:

      * deterministic across processes (no ``hash()`` randomization --
        the digest is sha256 over a canonical JSON encoding);
      * kwargs order never matters (``precision=..., comm_mode=...`` ==
        ``comm_mode=..., precision=...``: keys are sorted);
      * near-miss configs do NOT collide: a different value dtype, a
        different socket, a different comm/dma mode each change the key;
      * equivalent geometries DO collide (``n_det=None`` vs an explicit
        ``n_det=n`` name the same scan, so they share a cache entry).

    ``runtime`` values may be scalars, dtypes, or dataclasses of those
    (e.g. ``recon=ReconConfig(...)``); anything else raises TypeError
    rather than fingerprinting an unstable repr.
    """
    record = {
        # geometry, canonicalized: num_det resolves the n_det=None alias
        "geo": {
            "n": geo.n,
            "n_angles": geo.n_angles,
            "num_det": geo.num_det,
            "vox": _key_scalar(float(geo.vox)),
        },
        "partition": _key_scalar(cfg),
        "runtime": {k: _key_scalar(v) for k, v in runtime.items()},
    }
    blob = json.dumps(record, sort_keys=True, separators=(",", ":"))
    return "xct-" + hashlib.sha256(blob.encode()).hexdigest()[:16]


def exchange_volume_params(op: OperatorShards, topo) -> dict:
    """Wire-volume parameters for ``Topology.plan(mode, **params)``.

    One call covers every mode (``direct``/``rs``/``hier`` ignore the
    extras): ``pair_slots`` (flat sparse V), ``merged_rows`` (hier-sparse
    G*W) and ``cross_rows`` (n_slow*V2) plus ``dense_rows``.  Exact table
    capacities when the operator carries real shards; the analytic
    estimates (``est_v`` / :func:`estimate_hier_sparse`) for abstract
    ``estimate_plan`` shards.
    """
    fast = topo.levels[0].size if topo.levels else 1
    n_slow = max(1, topo.n_data // fast)
    # building the exact tables is O(P^2 V); memoize per ladder shape so
    # sweeps interrogating many (mode, fuse) cells pay it once
    cache = getattr(op, "_volume_params", None)
    if cache is None:
        cache = {}
        op._volume_params = cache  # type: ignore[attr-defined]
    key = (fast, n_slow)
    if key not in cache:
        if isinstance(op.row_map, np.ndarray):
            _, _, v = build_sparse_exchange(op)
            _, _, _, w, v2 = build_hier_sparse_exchange(op, fast)
        else:
            v = int(getattr(op, "est_v", 8))
            w, v2 = estimate_hier_sparse(op, fast, n_slow)
        cache[key] = {
            "pair_slots": v,
            "dense_rows": op.n_rows_pad,
            "merged_rows": fast * w,
            "cross_rows": n_slow * v2,
        }
    return dict(cache[key])


_OP_ARRAYS = ("inds", "vals", "winmap", "row_map", "winsegs", "segoff")
_OP_SCALARS = (
    "n_rows_pad", "n_cols_pad", "rows_per_dev", "cols_per_dev", "nnz"
)
_PLAN_ARRAYS = ("row_perm", "col_perm", "row_pos", "col_pos")


def plan_to_arrays(plan) -> dict[str, np.ndarray]:
    """Flatten a plan into ``{name: ndarray}`` under the reference's field
    names (``proj.inds``, ``proj.winsegs``, ``row_perm``, ``back.nnz``,
    ...; ``proj.foot_rows.<p>`` per device).  Reads attributes only, so a
    plan of either package flattens the same way; ``None`` fields are
    left out."""
    out: dict[str, np.ndarray] = {}
    for name in _PLAN_ARRAYS:
        v = getattr(plan, name)
        if v is not None:
            out[name] = np.asarray(v)
    for prefix in ("proj", "back"):
        op = getattr(plan, prefix)
        for name in _OP_ARRAYS:
            v = getattr(op, name)
            if v is not None:
                out[f"{prefix}.{name}"] = np.asarray(v)
        for name in _OP_SCALARS:
            out[f"{prefix}.{name}"] = np.asarray(getattr(op, name))
        for p, rows in enumerate(op.foot_rows):
            out[f"{prefix}.foot_rows.{p}"] = np.asarray(rows)
    return out


def plan_from_arrays(
    d: dict[str, np.ndarray], geo: XCTGeometry, cfg: PartitionConfig
) -> Plan:
    """Rebuild a :class:`Plan` from :func:`plan_to_arrays`' dict.

    The arrays are taken as they are (no copy beyond ``np.asarray``), so
    a plan built by the reference package runs here unchanged.
    """

    def op(prefix: str) -> OperatorShards:
        n_dev = np.asarray(d[f"{prefix}.inds"]).shape[0]
        if n_dev != cfg.n_data:
            raise ValueError(
                f"{prefix} shards cover {n_dev} devices but "
                f"cfg.n_data={cfg.n_data}"
            )
        arrs = {
            name: (
                np.asarray(d[f"{prefix}.{name}"])
                if f"{prefix}.{name}" in d else None
            )
            for name in _OP_ARRAYS
        }
        scalars = {
            name: int(np.asarray(d[f"{prefix}.{name}"]))
            for name in _OP_SCALARS
        }
        foot = [
            np.asarray(d[f"{prefix}.foot_rows.{p}"]) for p in range(n_dev)
        ]
        return OperatorShards(foot_rows=foot, **arrs, **scalars)

    top = {
        name: (np.asarray(d[name]) if name in d else None)
        for name in _PLAN_ARRAYS
    }
    return Plan(geo=geo, cfg=cfg, proj=op("proj"), back=op("back"), **top)
