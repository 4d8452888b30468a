"""LM training driver: the reference's ``launch/train.py`` in PyTorch.

Runs any ``--arch`` (full or ``--smoke``) with the full substrate:
deterministic data pipeline (``data.tokens.TokenStream``), AdamW,
checkpointing with atomic publish + resume (``ckpt.CheckpointManager``),
straggler monitoring, and either spmd or hierarchical mixed-precision
gradient sync (the paper's technique, ``models.lm.make_hier_train_step``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --steps 30 --batch 8 --seq 32 --device cpu

``--device`` is ``cuda`` by default, which raises without a card; ``cpu``
runs the same code on the host.  The mesh is ``(pod=1, data=1,
model=n)`` over the device's visible cards (one position on the CPU),
as the reference's ``make_cpu_mesh`` builds it, and the state is laid
out on it by ``param_specs`` (``dist.sharding.place_state``): each
position holds its pieces of the parameters and of AdamW's moments, and
the step splits its work over ``model`` (tensor parallelism).  A
checkpoint holds whole tensors and is laid out again on restore.
Weights come from ``models.transformer.init_params`` with a generator
seeded by ``--seed``: the reference draws its own with ``jax.random``,
so the two CLIs train different numbers of the same distributions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs import get_config
from ..core.recon import resolve_device
from ..data.tokens import TokenStream
from ..dist.fault import StragglerMonitor, suggest_checkpoint_period
from ..dist.sharding import PlacedTree, place_state
from ..models.lm import make_hier_train_step, make_train_step
from ..models.transformer import init_params
from ..opt.adam import AdamW
from ..opt.tree import leaves, unflatten
from .mesh import make_mesh

__all__ = ["load_state", "main", "make_device_mesh", "state_tree"]


def make_device_mesh(device: torch.device):
    """``(pod=1, data=1, model=n)`` over the visible cards (``n`` = 1 on
    the CPU)."""
    if device.type == "cuda":
        n = torch.cuda.device_count()
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        n, devs = 1, [device]
    return make_mesh((1, 1, n), ("pod", "data", "model"), devices=devs)


def state_tree(params, opt_state, step: int) -> dict:
    """The training state as a checkpoint tree of dicts and lists (the
    parameters and moments in ``opt.tree.leaves`` order); a laid-out
    state (``dist.sharding.PlacedTree``) is joined first
    (``Placed.full``), so the checkpoint holds whole tensors."""
    if isinstance(params, PlacedTree):
        params = params.full()
        opt_state = {k: v.full() for k, v in opt_state.items()}
    return {"params": leaves(params),
            "opt": {"m": leaves(opt_state["m"]), "v": leaves(opt_state["v"]),
                    "count": opt_state["count"]},
            "step": torch.tensor(step, dtype=torch.int32)}


def load_state(tree, params, opt_state):
    """``(params, opt_state, step)`` from a :func:`state_tree` (restored
    as tensors), in the structures of ``params`` and ``opt_state``.
    Where ``params`` is laid out on a mesh, the restored state is laid
    out on that mesh (``dist.sharding.place_state``), whatever the
    ``model`` size of the mesh it was saved from."""
    if isinstance(params, PlacedTree):
        whole = {k: v.full() for k, v in opt_state.items()}
        p, o, step = load_state(tree, params.full(), whole)
        p, o = place_state(p, o, params.mesh)
        return p, o, step
    new = unflatten(params, tree["params"])
    opt = {"m": unflatten(opt_state["m"], tree["opt"]["m"]),
           "v": unflatten(opt_state["v"], tree["opt"]["v"]),
           "count": tree["opt"]["count"].to(torch.int32)}
    return new, opt, int(tree["step"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-comm", choices=("spmd", "hier"),
                    default="spmd")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = make_device_mesh(device)
    opt = AdamW(lr=args.lr)

    def init_all():
        params = init_params(
            cfg, torch.Generator(device).manual_seed(args.seed))
        return place_state(params, opt.init(params), mesh)

    params, opt_state = init_all()
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every, keep=3)
        tree, start_step = mgr.restore_or_init(
            lambda: state_tree(params, opt_state, 0), device=device)
        if start_step:
            params, opt_state, _ = load_state(tree, params, opt_state)
            print(f"resumed from step {start_step}")

    split = sum(1 for pl in params.leaves if pl.model_dim() is not None)
    print(f"mesh {dict(mesh.shape)}: {split} of {len(params.leaves)} "
          "parameter leaves split over 'model'; bytes per position "
          "(parameters, m, v): " + ", ".join(
              f"{idx}: {params.bytes_at(idx)}, "
              f"{opt_state['m'].bytes_at(idx)}, "
              f"{opt_state['v'].bytes_at(idx)}"
              for idx in np.ndindex(mesh.devices.shape)))

    if args.grad_comm == "hier":
        step_fn = make_hier_train_step(cfg, opt, mesh)
        print(step_fn.topology.describe())
        print(step_fn.plan.describe())
    else:
        step_fn = make_train_step(cfg, opt, mesh)

    stream = TokenStream(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
    )
    monitor = StragglerMonitor()
    print(
        "suggested ckpt period @1000 nodes: "
        f"{suggest_checkpoint_period(30.0, 1000):.0f}s"
    )

    losses = []
    for step in range(start_step, args.steps):
        batch = stream.batch(step)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])  # waits for the device
        monitor.record(0, time.time() - t0)
        losses.append(loss)
        if step % args.log_every == 0:
            print(
                f"step {step:5d} loss {loss:8.4f} "
                f"dt {time.time()-t0:6.2f}s"
            )
        if mgr:
            mgr.maybe_save(step + 1, state_tree(params, opt_state, step + 1))
    if losses:
        print(
            f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
            f"stragglers: {monitor.stragglers()}"
        )
    return losses


if __name__ == "__main__":
    main()
