"""Dry run at the paper's scale: the port's programs on placeholder devices.

No arrays are allocated.  The XCT cells: ``Reconstructor(...,
abstract=True)`` binds every operator shard and exchange table of an
``estimate_plan`` plan as a fake tensor on a placeholder of its rank's
device (``launch.mesh.make_production_mesh``: 256 or 512 of them), and
``Reconstructor.lower_cg`` runs the port's own CG solve on fake inputs
(``core.lowering``).  The LM cells (:func:`lower_lm_cell`): the port's
own training step (``models.lm.make_hier_train_step``, one step under
``remat="full"``), ``prefill`` or ``decode_step`` runs on fake
parameters, optimizer state, caches and batches, with autograd, the
checkpoints' recompute and a FLOP count.  What a cell returns is the
counterpart of the reference's compiled memory analysis and HLO
collectives: each rank's bound, temporary and peak bytes, and the bytes
of every copy between devices by link class and kind.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--hints] \
      [--smoke] [--out results.json]
  python -m repro_torch.launch.dryrun --xct xct-brain [--multi-pod] \
      [--out results.json]
  python -m repro_torch.launch.dryrun --socket-sweep [--xct xct-brain]

``--arch`` alone traces every shape of that arch, ``--shape`` alone
every arch at that shape; ``--smoke`` takes the archs' SMOKE widths (a
quick check of the path).

The state is laid out as the reference's ``shardings(param_specs)``
places it, and the programs split their work over ``"model"`` as GSPMD
partitions the reference's (``models.transformer.forward_group``): each
rank holds its pieces and does its share; the copies between a group's
ranks are its collectives (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``).  Only model ranks 0 and 1 of a
group run under the trace; the others are phantoms
(``collectives.ModelGroup``) that send the live ranks fake tensors of
their shares and take rank 1's numbers (:func:`_fill_phantoms`).

Stated divergences of the LM cells from the reference's:

* the train cells run the hier step (the paper's ladder over the data
  axes, ``"scatter"`` of the batch's rows from rank 0) where the
  reference's cell runs its spmd step;
* a phantom rank's unfused bytes are rank 1's, which leave out the sums
  of the gradients the phantoms send back (within 5% of a full trace at
  four ranks, ``test_rank_replay_equals_every_rank_traced``);
* no HLO: the copies are the trace's (``Lowered.collectives()``), not
  ``analyze_collectives`` of compiled text; FLOPs and bytes accessed are
  counted op by op, unfused;
* a trace, not a compile: ``trace_s`` stands where ``lower_s`` and
  ``compile_s`` were, and every layer is traced (no finite difference
  over layers, ``_cost_numbers``);
* xlstm-350m's time loop is a Python loop over the length: its train and
  prefill cells are traced at three short lengths and extrapolated
  (``"fd(time: ...)"``), and ``_recurrent_flops_correction`` is not
  added (the trace counts every step's products);
* ``--hints``: the port has no sharding hints, so a hinted cell traces
  the plain cell's program, with the overrides in its record.

The XCT cells pair the traced numbers with ``xct_analytic``, a
slot-exact cost model over the static blocked-ELL shapes.  Its wire
volumes are not hand-rolled here: they flow from ``dist.CommPlan``'s
per-link-class model, resolved against the cell's ``dist.Topology`` (so
the dry run and the §Perf sweep can never disagree about what a mode
ships over ICI vs DCI).

Example -- the analytic model is pure accounting, usable without any
devices attached (a meshless two-level ladder, one CG iteration):

>>> from repro_torch.core.geometry import XCTGeometry
>>> from repro_torch.core.partition import PartitionConfig, estimate_plan
>>> from repro_torch.core.recon import ReconConfig
>>> from repro_torch.dist import Topology
>>> plan = estimate_plan(
...     XCTGeometry(n=512, n_angles=256),
...     PartitionConfig(n_data=16, tile=32, rows_per_block=64,
...                     nnz_per_stage=64),
... )
>>> topo = Topology.from_sizes([("model", 8, "ici"), ("data", 2, "dci")])
>>> an = xct_analytic(
...     plan, ReconConfig(precision="mixed", comm_mode="hier"), topo,
...     fuse=4, iters=1,
... )
>>> sorted(an) == ['dci_dev', 'dma_issues_dev', 'flops_dev', 'hbm_dev',
...                'ici_dev']
True
>>> an["dci_dev"] == an["ici_dev"] / 8  # ladder: 1/|socket| crosses DCI
True
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback

import numpy as np
import torch

from ..configs import ARCH_NAMES, SHAPES, get_config
from ..configs.xct_datasets import DATASETS
from ..placement import placeholder
from . import hardware
from .mesh import make_fake_mesh, make_production_mesh
from .roofline import roofline

__all__ = [
    "DP_AXES",
    "cell_mesh",
    "lower_lm_cell",
    "lower_xct_cell",
    "socket_sweep",
    "xct_analytic",
    "main",
]


def cell_mesh(dataset: str, multi_pod: bool):
    """``(mesh, data_axes, batch_axes, p_data)`` of a dataset's dry-run
    cell: the paper's strategy, data parallelism over ``p_data`` devices
    (the dataset's, up to the pod: 256, or 512 across two pods) and batch
    parallelism over slices on the rest.

    Where ``p_data`` is below the pod's 256 (xct-shale, xct-chip: 64) the
    pod's ``"data"`` axis is split into ``("batch", "data")``, so that the
    data axes hold ``p_data`` devices and ``"batch"`` carries the other
    replicas; the device numbering is the production mesh's.  (The
    reference binds such a plan to all 256 devices of the pod and
    raises.)

    >>> mesh, data, batch, p = cell_mesh("xct-shale", multi_pod=False)
    >>> mesh.shape, data, batch, p
    ({'batch': 4, 'data': 4, 'model': 16}, ('model', 'data'), ('batch',), 64)
    >>> cell_mesh("xct-brain", multi_pod=True)[1:]
    (('model', 'data', 'pod'), (), 512)
    """
    ds = DATASETS[dataset]
    mesh = make_production_mesh(multi_pod=multi_pod)
    fast = mesh.shape["model"]
    pod = mesh.shape["data"] * fast
    p_data = min(ds.p_data, mesh.size)
    if multi_pod and p_data >= 512:
        return mesh, ("model", "data", "pod"), (), p_data
    p_data = min(p_data, pod)
    batch = ("pod",) if multi_pod else ()
    if p_data < pod:
        data = p_data // fast
        if data * fast != p_data or mesh.shape["data"] % data:
            raise ValueError(
                f"p_data={p_data} does not tile a {mesh.shape} mesh"
            )
        shape = (mesh.shape["data"] // data, data, fast)
        names = ("batch", "data", "model")
        if multi_pod:
            shape, names = (mesh.shape["pod"],) + shape, ("pod",) + names
        mesh = make_fake_mesh(shape, names)
        batch = batch + ("batch",)
    return mesh, ("model", "data"), batch, p_data


def lower_xct_cell(dataset: str, multi_pod: bool, iters: int = 2, *,
                   use_ref: bool = True, hw=None) -> dict:
    """Dry-run the XCT CG step at full dataset scale (abstract shards).

    The reference's cell: ``PartitionConfig(tile=32, rows_per_block=64,
    nnz_per_stage=64)`` with the socket-aware layout, ``mixed_bf16``,
    ``hier``, ``fuse=16``, one fused minibatch per batch group, ``iters``
    CG iterations, the oracle's path (``use_ref=True``: its gathered
    window is what the reference's XLA program materializes; ``False``
    runs the kernel path, whose SpMM temp is the kernel's output band).
    ``hw`` (default ``launch.hardware.HW``) prices the roofline.

    The record has the reference's keys, with ``collectives_traced``
    (:meth:`~repro_torch.core.lowering.LoweredCG.collectives`) in the
    place of ``collectives_hlo``; ``rank0_bytes`` is rank 0's peak (its
    shards, its rows of the CG vectors and the run's temporaries) and
    ``card_bytes`` the card's memory (``hw.hbm_bytes``).
    """
    from ..core.geometry import XCTGeometry
    from ..core.partition import (
        PartitionConfig, default_socket, estimate_plan,
    )
    from ..core.recon import ReconConfig, Reconstructor
    from ..dist import Topology

    hw = hardware.HW if hw is None else hw
    ds = DATASETS[dataset]
    mesh, data_axes, batch_axes, p_data = cell_mesh(dataset, multi_pod)
    geo = XCTGeometry(n=ds.n, n_angles=ds.k)
    pcfg = PartitionConfig(
        n_data=p_data, tile=32, rows_per_block=64, nnz_per_stage=64,
        socket=default_socket(p_data, mesh.shape["model"]),
    )
    plan = estimate_plan(geo, pcfg)
    rcfg = ReconConfig(precision="mixed_bf16", comm_mode="hier", fuse=16,
                       use_ref=use_ref)
    topo = Topology.from_mesh(
        mesh, data_axes=data_axes, batch_axes=batch_axes
    )
    rec = Reconstructor(plan, rcfg, topology=topo, abstract=True)
    n_batch = rec.n_batch
    y_slices = rcfg.fuse * n_batch  # one fused I/O batch per batch group
    t0 = time.time()
    lowered = rec.lower_cg(y_slices, iters=iters)
    t1 = time.time()
    mem = lowered.memory_analysis()
    coll = lowered.collectives()
    an = xct_analytic(plan, rcfg, topo, y_slices // n_batch, iters)
    # useful flops: 2 flops/nnz * 2 ops (proj+back) * fuse slices * iters
    nnz_total = geo.n_rays * 1.195 * ds.n
    useful = 4.0 * nnz_total * (y_slices // n_batch) * iters / p_data
    rf = roofline(
        an["flops_dev"], an["hbm_dev"], an["ici_dev"],
        an["dci_dev"] if multi_pod else 0.0,
        useful, hw=hw, hbm_bytes_analytic=an["hbm_dev"],
    )
    return {
        "status": "ok", "arch": dataset, "shape": f"cg{iters}x{y_slices}sl",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "comm_mode": rcfg.comm_mode,
        "compile_s": round(t1 - t0, 1),
        "p_data": p_data,
        "memory": {
            "temp_bytes": mem.temp_size_in_bytes,
            "arg_bytes": mem.argument_size_in_bytes,
            "input_bytes": mem.input_size_in_bytes,
            "out_bytes": mem.output_size_in_bytes,
            "peak_bytes": mem.peak_size_in_bytes,
            "rank": mem.rank,
            # the most any rank but rank 0 holds, beside rank0's peak
            "peak_others": int(max(mem.per_rank["peak"][1:], default=0)),
            "rank0": mem.rank0,
            "notes": lowered.notes,
        },
        "flops_per_dev": an["flops_dev"],
        "hbm_bytes_per_dev": an["hbm_dev"],
        "ici_bytes_per_dev": an["ici_dev"],
        "dci_bytes_per_dev": an["dci_dev"] if multi_pod else 0.0,
        "collectives_traced": coll,
        "analytic": an,
        "roofline": rf,
        "rank0_bytes": mem.rank0["peak"],
        "card_bytes": hw.hbm_bytes,
    }


# --------------------------------------------------------------------- #
# the LM cells
# --------------------------------------------------------------------- #
DP_AXES = ("pod", "data")
# the xLSTM time loop's finite difference: three evenly spaced traced
# lengths; a cell's length must lie on their grid
FD_STEPS = (8, 16, 24)
FLOPS_COUNTED = ("torch.utils.flop_counter's formulas: matrix products "
                 "(mm, addmm, bmm, baddbmm), convolutions and attention "
                 "kernels, forward, backward and recompute; elementwise "
                 "work is not counted")


def _useful_flops(cfg, shape_kind, tokens, n_dev):
    n_active = cfg.active_param_count()
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n_active * tokens / n_dev


def _recurrent_flops_correction(cfg, kind, batch, seq) -> float:
    """Per-device extra FLOPs for time-scanned recurrent cells: the
    reference's, which adds the ``T - 1`` repetitions of the mLSTM /
    sLSTM time step that XLA's ``cost_analysis`` counts once.  The
    port's trace runs every time step (extrapolated by the time FD), so
    its cells do not add it; it is kept for parity with the reference's
    model."""
    if kind == "decode":
        return 0.0
    per_tok = 0.0
    d = cfg.d_model
    for k in cfg.pattern_kinds:
        if k == "mlstm":
            dn = cfg.mlstm_expansion * d
            hd = dn // cfg.n_heads
            per_tok += cfg.n_heads * (5 * hd * hd + 6 * hd)
        elif k == "slstm":
            per_tok += 8 * d * d + 25 * d
    mult = 3.0 if kind == "train" else 1.0  # fwd + ~2x bwd
    return per_tok * batch * (seq - 1) * mult


def _hint_overrides(arch, dp, kind: str = "train"):
    """Sharding-hint config for the optimized (§Perf) variants, the
    reference's rule.  The port has no sharding hints: the fields change
    nothing it runs, and a ``--hints`` cell traces the plain cell's
    program, with these overrides in its record.

    kv divides the model axis -> shard kv; MQA (kv=1) and *prefill* cells
    -> query-time (context parallel; no backward resharding cost); train
    cells with total heads divisible -> merged-heads; else query-time.
    """
    cfg = get_config(arch)
    kv_ok = cfg.n_kv_heads % 16 == 0
    h_ok = cfg.n_heads % 16 == 0
    if kv_ok:
        q_shard, merge = False, False
    elif kind == "prefill" or cfg.n_kv_heads == 1:
        q_shard, merge = True, False
    elif h_ok:
        q_shard, merge = False, True
    else:
        q_shard, merge = True, False
    return {
        "shard_hints": True,
        "attn_heads_merge": merge,
        "attn_q_shard": q_shard,
        "dp_axes": dp,
    }


def _time_loop(cfg, kind) -> bool:
    """True where the cell runs the xLSTM time loop over its length."""
    return kind != "decode" and any(
        k in ("mlstm", "slstm") for k in cfg.pattern_kinds)


class _RankSteps:
    """``make_hier_train_step``'s ``rank_step`` under a trace.

    Each data rank's model group runs its loss and backward
    (``models.lm.group_value_and_grad``), a segment of its devices'
    timelines: each device's peak there is kept apart from the rest of
    the step's (``inside``, by device; the trace's own ``peak`` keeps
    what happens outside), so that the time FD extrapolates each part on
    its own.  With ``real`` set, only the first ``real`` data ranks run
    under the trace and each later one replays the last real one's (its
    rows and its pieces' shapes are the same), model rank by model
    rank: the rise of each device's peak over the bytes live when it
    started, its FLOPs and bytes accessed, the copies between the
    group's ranks (the tensor-parallel collectives, moved onto the
    replaying group's devices), and its outputs, fake tensors of the
    same shapes on the same ranks.  The copies a data rank's step sends
    to or receives from other data ranks are outside ``rank_step`` and
    traced for every data rank."""

    def __init__(self, trace, real: int | None = 2):
        self.trace, self.real = trace, real
        self.calls, self.replayed, self.last = 0, 0, None
        self.inside: dict = {}

    def __call__(self, pieces, template, cfg, shards, group):
        from ..core.lowering import tally
        from ..models.lm import group_value_and_grad

        trace = self.trace
        devs = {r: group.devices[r] for r in group.live}
        self.calls += 1
        if self.real is not None and self.calls > self.real:
            return self._replay(group)
        before = {r: (trace.live.get(d, 0), trace.peak.get(d, 0),
                      trace.flops.get(d, 0), trace.bytes_accessed.get(d, 0))
                  for r, d in devs.items()}
        n_copies = len(trace.copies)
        for r, d in devs.items():
            trace.peak[d] = before[r][0]
        loss, metrics, grads = group_value_and_grad(pieces, template, cfg,
                                                    shards, group)
        rank_of = {str(d): r for r, d in enumerate(group.devices)}
        rec = {"rise": {}, "flops": {}, "bytes": {}}
        for r, d in devs.items():
            live0, outside, f0, b0 = before[r]
            rec["rise"][r] = trace.peak[d] - live0
            self._inside(d, trace.peak[d])
            trace.peak[d] = max(outside, trace.live.get(d, 0))
            rec["flops"][r] = trace.flops.get(d, 0) - f0
            rec["bytes"][r] = trace.bytes_accessed.get(d, 0) - b0
        rec["copies"] = [(rank_of[str(c.src)], rank_of[str(c.dst)], c.nbytes,
                          c.link, c.kind, c.count)
                         for c in tally(trace.copies[n_copies:])]
        r0 = group.live[0]
        outs = [(r0, loss)] + [(r0, metrics[k]) for k in sorted(metrics)]
        outs += [(r, g[r]) for g in grads for r in group.live]
        rec["keys"] = sorted(metrics)
        rec["shapes"] = [(r, tuple(t.shape), t.dtype) for r, t in outs]
        self.last = rec
        return loss, metrics, grads

    def _inside(self, dev, peak):
        self.inside[dev] = max(self.inside.get(dev, 0), peak)

    def _replay(self, group):
        from ..core.lowering import Copy

        trace, rec = self.trace, self.last
        self.replayed += 1
        for r in group.live:
            d = group.devices[r]
            self._inside(d, trace.live.get(d, 0) + rec["rise"][r])
            trace.flops[d] = trace.flops.get(d, 0) + rec["flops"][r]
            trace.bytes_accessed[d] = (trace.bytes_accessed.get(d, 0)
                                       + rec["bytes"][r])
        for src, dst, nbytes, link, kind, count in rec["copies"]:
            trace.copies.append(Copy(group.devices[src], group.devices[dst],
                                     nbytes, link, kind, count))
        outs = [(r, trace.empty(shape, dt, group.devices[r]))
                for r, shape, dt in rec["shapes"]]
        for r in group.live:
            d = group.devices[r]
            trace.peak[d] = max(trace.peak.get(d, 0), trace.live.get(d, 0))
        n = len(rec["keys"])
        loss = outs[0][1]
        metrics = dict(zip(rec["keys"], [t for _, t in outs[1:1 + n]]))
        rest = iter(outs[1 + n:])
        grads = []
        while True:
            g = [None] * group.n
            try:
                for r in group.live:
                    g[r] = next(rest)[1]
            except StopIteration:
                break
            grads.append(g)
        return loss, metrics, grads


def _live_ranks(mesh, replay: bool):
    """The model ranks a cell traces: all, or with ``replay`` ranks 0
    and 1 where the group has more, the others phantoms
    (``collectives.ModelGroup``) whose numbers :func:`_fill_phantoms`
    copies from rank 1's."""
    n = mesh.shape.get("model", 1)
    return None if not replay or n <= 2 else (0, 1)


def _build_cell(cfg, kind, seq, batch, mesh, dp, trace, replay=True):
    """The port's program of one cell on ``mesh``'s placeholders:
    ``(fn, args, devices, info)``.  ``args`` are fake tensors made under
    ``trace.binding()``; ``fn()`` runs the program on them; ``devices``
    are the ranks' placeholders (data rank major, model rank minor).

    The parameters (and in training AdamW's moments) are laid out as
    the reference's ``shardings(param_specs)`` places them
    (``dist.sharding.place_state``): each position holds its pieces.
    train: ``make_hier_train_step(cfg, AdamW(), mesh, dp_axes=dp)``, one
    step, every data rank's model group splitting its work over
    ``"model"``; rank 0 holds the batch.  With ``replay`` only data
    ranks 0 and 1 run their loss and backward under the trace and the
    others replay rank 1's (:class:`_RankSteps`), and only model ranks 0
    and 1 compute (:func:`_live_ranks`).
    prefill / decode: the first data rank's model group serves
    ``prefill`` / ``decode_step`` with ``batch / n_dp`` rows, or the
    whole batch where the reference's batch spec would replicate it
    (``batch % n_dp != 0``), from rank 0; decode at position ``seq - 1``,
    each rank holding its piece of the cache
    (``transformer.init_cache_group``).
    """
    from ..dist.collectives import ModelGroup
    from ..dist.sharding import place_state
    from ..models.layers import Unseeded
    from ..models.lm import (
        _groups, decode_step, make_hier_train_step, prefill,
    )
    from ..models.transformer import init_cache_group, init_params
    from ..opt import AdamW

    ndp = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1
    split = bool(dp) and batch % ndp == 0
    home = placeholder(mesh.devices[(0,) * mesh.devices.ndim])
    rows = batch // ndp if split else batch  # a rank's, or a replica's
    adt = torch.bfloat16
    live = _live_ranks(mesh, replay)
    names = mesh.axis_names
    k = names.index("model") if "model" in names else None
    positions = None if live is None else {
        idx for idx in np.ndindex(mesh.devices.shape) if idx[k] in live}
    serve_dp = tuple(a for a in names if a != "model")

    def tokens_or_embeds(n, t):
        if cfg.embed_inputs:
            return torch.empty((n, t), dtype=torch.int32, device=home)
        return torch.empty((n, t, cfg.d_model), dtype=adt, device=home)

    info = {"rows": rows, "n_dp": ndp, "live": live}
    with trace.binding():
        params = init_params(cfg, Unseeded(home))
        if kind == "train":
            opt = AdamW()
            pp, po = place_state(params, opt.init(params), mesh,
                                 positions=positions)
            del params
            data = {"inputs": tokens_or_embeds(batch, seq),
                    "labels": torch.empty((batch, seq), dtype=torch.int32,
                                          device=home)}
            rank_step = _RankSteps(trace, 2 if replay else None)
            step = make_hier_train_step(cfg, opt, mesh, dp_axes=dp,
                                        rank_step=rank_step, live=live)
            args = (pp, po, data)
            devices = [placeholder(d) for _, g in _groups(mesh, dp)
                       for d in g.devices]
            info.update(program="make_hier_train_step(AdamW())",
                        rank_steps=rank_step)
            return (lambda: step(*args)), args, devices, info
        group = ModelGroup(_groups(mesh, serve_dp)[0][1].devices, live)
        first = {i for i in np.ndindex(mesh.devices.shape)
                 if all(c == 0 for j, c in enumerate(i) if j != k)}
        pp, _ = place_state(params, None, mesh, positions=first
                            if positions is None else first & positions)
        del params
        devices = [placeholder(d) for d in group.devices]
        if kind == "prefill":
            inputs = tokens_or_embeds(rows, seq)
            args = (pp, inputs)
            info["program"] = "prefill"
            return ((lambda: prefill(pp, cfg, inputs, group=group)), args,
                    devices, info)
        cache = init_cache_group(cfg, rows, group)
        for rank in cache:
            for c in rank or ():
                if "pos" in c:
                    c["pos"] = seq - 1
        token = tokens_or_embeds(rows, 1)
        args = (pp, cache, token)
        info["program"] = "decode_step"
        return ((lambda: decode_step(pp, cfg, cache, token, seq - 1,
                                     group=group)),
                args, devices, info)


def _trace_cell(cfg, kind, seq, batch, mesh, dp, replay=True):
    """One traced run of a cell's program: ``(Lowered, seconds, info,
    parts)``; ``parts`` splits each device's peak into the ranks' loss
    and backward (``"inside"``) and the rest of the step
    (``"outside"``), for :func:`_extrapolate`."""
    from ..core.lowering import FakeTrace, Lowered, tally

    trace = FakeTrace.for_mesh(mesh)
    t0 = time.perf_counter()
    fn, args, devices, info = _build_cell(
        cfg, kind, seq, batch, mesh, dp, trace, replay)
    bound = _tensors(args)
    with trace.running(bound, grad=(kind == "train")):
        out = fn()
        outputs = _per_device(trace, _tensors(out))
        parts = {"outside": dict(trace.peak), "inside": {}}
        flops, nbytes = dict(trace.flops), dict(trace.bytes_accessed)
        copies = tally(trace.copies)
    del out
    secs = time.perf_counter() - t0
    on = _per_device(trace, bound)
    rs = info.pop("rank_steps", None)
    if rs is not None:
        parts["inside"] = dict(rs.inside)
        info["ranks_traced"] = rs.calls - rs.replayed
        info["ranks_replayed"] = rs.replayed
    live = info.pop("live")
    if live is not None:
        copies = _fill_phantoms(mesh, live, devices, copies, on, outputs,
                                flops, nbytes, parts["outside"],
                                parts["inside"])
    argument = [on.get(d, 0) if i == devices.index(d) else 0
                for i, d in enumerate(devices)]
    return Lowered(devices=devices, argument=argument, bound=on, input={},
                   output=outputs, peak=_merge_peaks(parts), copies=copies,
                   flops=flops, bytes_accessed=nbytes), secs, info, parts


_GROUP_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


def _fill_phantoms(mesh, live, devices, copies, *per_device):
    """Give each phantom model rank (one not in ``live``, which holds
    ranks 0 and 1) of ``devices`` the numbers of model rank 1 of its
    group: each ``per_device`` dict (bound, output, FLOPs, bytes, the
    parts of the peak) takes rank 1's entry.  The copies with a phantom
    at either end are made anew: between two ranks of one group, a
    tensor-parallel collective's (``_GROUP_KINDS``), those that rank 0
    sent rank 1, moved onto the pair (the collectives treat every pair
    of ranks alike); every other copy with an end at rank 1 (the data
    ranks' ladder, the batch's scatter, the factors and norms sent to
    rank 0) once more with rank 1 and the phantom swapped.  Returns the
    copies, merged (``core.lowering.tally``)."""
    from ..core.lowering import Copy, tally

    names = mesh.axis_names
    k = names.index("model")
    at = {placeholder(mesh.devices[i]): i
          for i in np.ndindex(mesh.devices.shape)}
    dev = {i: d for d, i in at.items()}

    def to(d, r):
        i = list(at[d])
        i[k] = r
        return dev[tuple(i)]

    def inside(c):
        a, b = list(at[c.src]), list(at[c.dst])
        a[k] = b[k] = 0
        return a == b and c.kind in _GROUP_KINDS

    phantoms = [d for d in devices if at[d][k] not in live]
    for d in phantoms:
        src = to(d, 1)
        for table in per_device:
            if src in table:
                table[d] = table[src]
    ranks = range(mesh.shape["model"])
    out = tally(c for c in copies
                if at[c.src][k] in live and at[c.dst][k] in live)
    pair = [c for c in out if inside(c) and at[c.src][k] == 0
            and at[c.dst][k] == 1]
    for c in pair:
        for i in ranks:
            for j in ranks:
                if i != j and not (i in live and j in live):
                    out.append(Copy(to(c.src, i), to(c.dst, j), c.nbytes,
                                    c.link, c.kind, c.count))
    ones = [c for c in out if not inside(c)
            and 1 in (at[c.src][k], at[c.dst][k])]
    for p in ranks:
        if p not in live:
            out += [Copy(*(to(e, p) if at[e][k] == 1 else e
                           for e in (c.src, c.dst)), c.nbytes, c.link,
                         c.kind, c.count) for c in ones]
    return out


def _merge_peaks(parts) -> dict:
    out = dict(parts["outside"])
    for d, v in parts["inside"].items():
        out[d] = max(out.get(d, 0), v)
    return out


def _tensors(tree) -> list:
    """The tensors among ``tree``'s leaves (``opt.tree``: dicts, lists,
    modules; a cache's ``pos`` is an int), and the pieces of the laid-out
    ones (``dist.sharding.Placed`` and ``PlacedTree``)."""
    from ..dist.sharding import Placed, PlacedTree
    from ..opt.tree import leaves

    out = []
    for t in leaves(tree):
        if isinstance(t, PlacedTree):
            t = list(t.leaves)
        if isinstance(t, Placed):
            t = [t]
        if isinstance(t, list):
            out += [p for pl in t for p in pl.pieces.flat if p is not None]
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _per_device(trace, tensors) -> dict:
    """Distinct storage bytes of ``tensors`` by placeholder."""
    from ..core.lowering import storage_bytes

    on: dict = {}
    for t in tensors:
        on.setdefault(trace.device_of(t), []).append(t)
    return {d: storage_bytes(ts) for d, ts in on.items()}


def _extrapolate(runs, ts, t: int):
    """The :class:`~repro_torch.core.lowering.Lowered` at length ``t``
    from :func:`_trace_cell` runs (``(Lowered, parts)``) at the three
    evenly spaced lengths ``ts``: every count a polynomial of degree two
    at most in the length, in Newton's form ``f0 + k d1 + k (k - 1) / 2
    d2`` with ``k = (t - t0) / h`` an integer, exact in integers.  The
    counts are affine but for the bytes accessed: the backward of each
    step's slice of a ``[B, T, ...]`` tensor writes a gradient of the
    whole tensor, ``T`` times.  A device's peak is the larger of its two
    parts (:func:`_trace_cell`), each extrapolated on its own: the
    ranks' loss and backward grow with the length, the ladder and the
    optimizer's update do not, and the larger of the two at a short
    length need not be the larger at the cell's."""
    from ..core.lowering import Copy, Lowered

    t0, t1, t2 = ts
    h = t1 - t0
    k, r = divmod(t - t0, h)
    if t2 - t1 != h or h <= 0 or r or k < 0:
        raise ValueError(f"length {t} is not on the grid of {ts}")

    def fit(x0, x1, x2):
        return x0 + k * (x1 - x0) + k * (k - 1) // 2 * (x2 - 2 * x1 + x0)

    def per(*ds):
        keys = {d: None for m in ds for d in m}
        return {d: fit(*(m.get(d, 0) for m in ds)) for d in keys}

    (la, pa), (lb, pb), (lc, pc) = runs
    if not (la.devices == lb.devices == lc.devices
            and len(la.copies) == len(lb.copies) == len(lc.copies)):
        raise ValueError("the traces ran different programs")
    copies = []
    for ca, cb, cc in zip(la.copies, lb.copies, lc.copies):
        if not ((ca.src, ca.dst, ca.kind) == (cb.src, cb.dst, cb.kind)
                == (cc.src, cc.dst, cc.kind)):
            raise ValueError("the traces copied differently")
        copies.append(Copy(ca.src, ca.dst,
                           fit(ca.nbytes, cb.nbytes, cc.nbytes),
                           ca.link, ca.kind,
                           fit(ca.count, cb.count, cc.count)))
    parts = {key: per(pa[key], pb[key], pc[key])
             for key in ("outside", "inside")}
    return Lowered(
        devices=la.devices,
        argument=[fit(*x) for x in zip(la.argument, lb.argument,
                                       lc.argument)],
        bound=per(la.bound, lb.bound, lc.bound),
        input=per(la.input, lb.input, lc.input),
        output=per(la.output, lb.output, lc.output),
        peak=_merge_peaks(parts), copies=copies, notes=la.notes,
        flops=per(la.flops, lb.flops, lc.flops),
        bytes_accessed=per(la.bytes_accessed, lb.bytes_accessed,
                           lc.bytes_accessed))


def lower_lm_cell(
    arch: str, shape: str, multi_pod: bool, fd_cost: bool = True,
    overrides: dict | None = None, *, smoke: bool = False, mesh=None,
    seq: int | None = None, batch: int | None = None,
    replay: bool = True, hw=None,
) -> dict:
    """Trace one LM cell, the port's program for it on fake tensors.

    The cell is the reference's: ``SHAPES[shape]``'s length, global
    batch and kind on ``make_production_mesh(multi_pod)`` (or ``mesh``),
    data parallelism over ``DP_AXES``, ``remat="full"`` in training,
    ``max_cache`` the length; ``smoke`` takes the arch's SMOKE config,
    ``seq`` / ``batch`` cut the shape.  The program is the port's own
    (:func:`_build_cell`), run once under a ``core.lowering.FakeTrace``
    with autograd, the checkpoints' recompute and a FLOP count, every
    layer traced (``cost_source`` ``"trace(every layer)"``; the
    reference's finite difference over layers is not needed).  The
    exception is the xLSTM time loop, a Python loop over the length:
    with ``fd_cost`` the cell is traced at the three lengths
    ``FD_STEPS`` and extrapolated, every count being a polynomial of
    degree two at most in the number of steps without attention
    (:func:`_extrapolate`; ``"fd(time: T0, T1, T2)"``).

    The record has the reference's keys.  ``memory`` is the busiest
    rank's (``temp_bytes``, ``arg_bytes``, ``out_bytes``, with
    ``peak_bytes`` and ``rank``) and rank 0's (``rank0``);
    ``flops_per_dev`` and ``hbm_bytes_per_dev`` are the busiest
    device's traced FLOPs and unfused bytes read and written (the
    counterpart of XLA:CPU's pre-fusion "bytes accessed");
    ``ici_bytes_per_dev`` / ``dci_bytes_per_dev`` the traced copies
    between devices per rank, and ``collectives`` their tally
    (``Lowered.collectives()``); ``roofline`` prices them at ``hw``'s
    rates (default the H100's) with ``analytic_min_hbm``; ``trace_s``
    stands where the reference has ``lower_s`` / ``compile_s``; ``fits``
    holds the busiest rank's peak against the card's memory,
    ``card_bytes`` (``hw.hbm_bytes``).
    """
    from .hlo_analysis import analytic_min_hbm

    hw = hardware.HW if hw is None else hw
    seq0, batch0, kind = SHAPES[shape]
    seq = seq0 if seq is None else seq
    batch = batch0 if batch is None else batch
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None \
        else mesh
    mesh_name = "x".join(str(n) for n in mesh.devices.shape)
    n_dev = mesh.size
    dp = tuple(a for a in DP_AXES if a in mesh.shape)
    cfg = get_config(arch, smoke=smoke, **{
        "max_cache": seq, "remat": "full" if kind == "train" else "none",
        **(overrides or {})})
    if kind == "decode" and not cfg.sub_quadratic and shape == "long_500k":
        return {
            "status": "skipped(full-attention)",
            "arch": arch, "shape": shape, "mesh": mesh_name,
        }

    if fd_cost and _time_loop(cfg, kind):
        runs = [_trace_cell(dataclasses.replace(cfg, max_cache=t), kind, t,
                            batch, mesh, dp, replay) for t in FD_STEPS]
        lowered = _extrapolate([(r[0], r[3]) for r in runs], FD_STEPS, seq)
        trace_s = sum(r[1] for r in runs)
        info = runs[-1][2]
        cost_source = "fd(time: " + ", ".join(map(str, FD_STEPS)) + ")"
    else:
        lowered, trace_s, info, _ = _trace_cell(cfg, kind, seq, batch,
                                                mesh, dp, replay)
        cost_source = "trace(every layer)"
    tokens = batch * seq if kind != "decode" else batch
    mem = lowered.memory_analysis()
    coll = lowered.collectives()
    flops_dev = float(max(lowered.flops.values(), default=0))
    hbm_dev = float(max(lowered.bytes_accessed.values(), default=0))
    rf = roofline(
        flops_dev, hbm_dev, coll["ici_bytes"], coll["dci_bytes"],
        _useful_flops(cfg, kind, tokens, n_dev), hw=hw,
        hbm_bytes_analytic=analytic_min_hbm(cfg, kind, batch, seq, mesh),
    )
    rec = {
        "cost_source": cost_source,
        "status": "ok",
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
        "trace_s": round(trace_s, 3),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "memory": {
            "temp_bytes": mem.temp_size_in_bytes,
            "arg_bytes": mem.argument_size_in_bytes,
            "out_bytes": mem.output_size_in_bytes,
            "peak_bytes": mem.peak_size_in_bytes,
            "rank": mem.rank,
            "rank0": mem.rank0,
        },
        "flops_per_dev": flops_dev,
        "hbm_bytes_per_dev": hbm_dev,
        "ici_bytes_per_dev": coll["ici_bytes"],
        "dci_bytes_per_dev": coll["dci_bytes"],
        "collectives": coll,
        "roofline": rf,
        "fits": mem.peak_size_in_bytes <= hw.hbm_bytes,
        "card_bytes": hw.hbm_bytes,
        "flops_counted": FLOPS_COUNTED,
        "recurrent_correction": (
            "none: the trace counts every time step"
            if _time_loop(cfg, kind) else "none: no time loop"),
        "cell": {"kind": kind, "seq": seq, "batch": batch,
                 "ranks": len(lowered.devices), **info},
    }
    if overrides:
        rec["overrides"] = overrides
    return rec


def socket_sweep(
    dataset: str = "xct-brain",
    p_data: int = 512,
    fuse: int = 16,
    comm_bytes: int = 2,
) -> dict:
    """``PartitionConfig(socket=1)`` vs ``socket=fast`` at the paper's scale.

    Compares the modeled hier-sparse wire volume of the legacy scattered
    chunk layout (socket members' footprints ~ independent draws) against
    the socket-aware layout (members own consecutive Hilbert chunks;
    adjacent-chunk union model, ``core.partition.estimate_hier_sparse``)
    at production scale, on the production ladder
    (``xct_perf.sweep_topology``).  The winner is what
    ``core.partition.default_socket`` hands every caller.

    >>> sw = socket_sweep()
    >>> sw["fast"]
    16
    >>> sw["socket=16"]["dci"] < sw["socket=1"]["dci"]
    True
    >>> sw["winner"]
    16
    """
    from ..core.geometry import XCTGeometry
    from ..core.partition import PartitionConfig, estimate_plan
    from .xct_perf import comm_volume, sweep_topology

    ds = DATASETS[dataset]
    geo = XCTGeometry(n=ds.n, n_angles=ds.k)
    topo = sweep_topology(p_data)
    fast = topo.levels[0].size
    out = {"dataset": dataset, "p_data": p_data, "fast": fast}
    for socket in (1, fast):
        plan = estimate_plan(
            geo,
            PartitionConfig(
                n_data=p_data, tile=32, rows_per_block=64,
                nnz_per_stage=64, socket=socket,
            ),
        )
        out[f"socket={socket}"] = comm_volume(
            plan, "hier-sparse", fuse, comm_bytes, topo
        )
    key = "dci" if out[f"socket={fast}"]["dci"] else "ici"
    out["winner"] = (
        fast
        if out[f"socket={fast}"][key] < out["socket=1"][key]
        else 1
    )
    return out


def xct_analytic(plan, rcfg, topo, fuse: int, iters: int) -> dict:
    """Slot-exact per-device cost model for the XCT CG step.

    FLOPs and bytes come from the static blocked-ELL shapes through the
    shared ``kernels.traffic.spmm_traffic`` model (2 FLOPs per nnz slot
    per fused slice, the operator's slot bytes, and the staging term
    matching ``rcfg.staging`` -- the default in-kernel staging has no
    device-memory window round trip, so modeled arithmetic intensity is
    strictly higher than the gather baseline).  The exchange volume per
    reduction is whatever ``topo.plan(rcfg.comm_mode)`` models for each
    link class -- one source of truth shared with the runtime
    collectives.

    ``dma_issues_dev`` counts the window-staging copies the kernel
    issues (one per run-length segment under the default
    ``rcfg.dma="coalesced"``, one per winmap row under ``"per_row"``)
    so rooflines can price the fixed per-copy overhead with
    ``kernels.traffic.dma_issue_seconds``.
    """
    from ..core.partition import exchange_volume_params
    from ..core.precision import get_policy
    from ..kernels.traffic import op_segments_per_stage, spmm_traffic

    pol = get_policy(rcfg.precision)
    sb, cb = pol.storage_bytes, pol.comm_bytes
    wire = getattr(rcfg, "wire", "native")
    out = {"flops_dev": 0.0, "hbm_dev": 0.0, "ici_dev": 0.0,
           "dci_dev": 0.0, "dma_issues_dev": 0.0}
    for op in (plan.proj, plan.back):
        _, b, s, r, k = op.inds.shape
        segs = op_segments_per_stage(op)
        t = spmm_traffic(
            b, s, r, k, op.winmap.shape[-1], fuse, storage_bytes=sb,
            vals_bytes=pol.vals_bytes,
            staging=getattr(rcfg, "staging", "fused"),
            dma=getattr(rcfg, "dma", "coalesced"),
            segments_per_stage=segs,
        )
        out["flops_dev"] += iters * t["flops"]
        out["hbm_dev"] += iters * t["hbm_bytes"]
        out["dma_issues_dev"] += iters * t["dma_issues"]
        dense = float(op.n_rows_pad) * fuse * cb
        params = (
            exchange_volume_params(op, topo)
            if rcfg.comm_mode in ("sparse", "hier-sparse") else {}
        )
        wl = topo.plan(
            rcfg.comm_mode, wire=wire, comm_bytes=cb, **params
        ).wire_bytes_by_link(dense)
        out["ici_dev"] += iters * wl.get("ici", 0.0)
        out["dci_dev"] += iters * wl.get("dci", 0.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--xct", help="dataset of launch.dryrun's XCT cell")
    ap.add_argument(
        "--socket-sweep", action="store_true",
        help="socket=1 vs socket=fast hier-sparse volume at xct scale",
    )
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--kernel-path", action="store_true",
                    help="trace the kernel path instead of the oracle's")
    ap.add_argument("--out", default=None)
    ap.add_argument("--arch", choices=ARCH_NAMES,
                    help="LM cell(s) of this arch (every shape without "
                    "--shape)")
    ap.add_argument("--shape", choices=tuple(SHAPES),
                    help="LM cell(s) of this shape (every arch without "
                    "--arch)")
    ap.add_argument("--all", action="store_true",
                    help="every LM cell (arch x shape)")
    ap.add_argument(
        "--hints", action="store_true",
        help="the reference's §Perf sharding hints in the config (the "
        "port has none: the same program, the overrides recorded)",
    )
    ap.add_argument("--smoke", action="store_true",
                    help="LM cells at the archs' SMOKE widths")
    args = ap.parse_args(argv)
    lm = bool(args.arch or args.shape or args.all)
    if not (lm or args.xct or args.socket_sweep):
        ap.error("give --arch / --shape / --all, --xct DATASET or "
                 "--socket-sweep")
    mesh0 = make_production_mesh(multi_pod=args.multi_pod)
    dp0 = tuple(a for a in DP_AXES if a in mesh0.shape)

    def ov(arch, shape):
        if not args.hints:
            return None
        return _hint_overrides(arch, dp0, SHAPES[shape][2])

    results = []

    def run(fn, *a, **kw):
        try:
            r = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 -- record & continue
            r = {
                "status": f"error: {type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:],
            }
        results.append(r)
        print(json.dumps(r, default=str))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=str)

    if args.socket_sweep:
        run(socket_sweep, args.xct or "xct-brain")
    elif args.xct:
        run(lower_xct_cell, args.xct, args.multi_pod,
            use_ref=not args.kernel_path)
    else:
        archs = ARCH_NAMES if args.all or not args.arch else (args.arch,)
        shapes = (tuple(SHAPES) if args.all or not args.shape
                  else (args.shape,))
        for arch in archs:
            for shape in shapes:
                if len(archs) * len(shapes) > 1:
                    print(f"--- {arch} x {shape} ---", flush=True)
                run(lower_lm_cell, arch, shape, args.multi_pod, True,
                    ov(arch, shape), smoke=args.smoke)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
