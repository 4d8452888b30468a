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

A plan is pure numpy: :func:`plan_to_arrays` / :func:`plan_from_arrays`
carry one across as a flat ``{name: ndarray}`` dict (what weights are to
a model, the plan is to this system).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.sparse as sp

from .geometry import XCTGeometry, build_system_matrix
from .hilbert import tile_hilbert_order

__all__ = [
    "PartitionConfig",
    "OperatorShards",
    "Plan",
    "build_plan",
    "default_socket",
    "plan_from_arrays",
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
        the O(VMEM) double buffer, see ``kernels.xct_spmm.vmem_bytes``).

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
