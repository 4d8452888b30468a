"""LM training on the PyTorch port (``models/lm.py``'s loss and train
steps, ``opt/``, ``data/tokens.py``, ``dist/sharding.py``,
``dist/fault.remesh``, ``launch/train.py``) against the JAX package on
the CPU: the same seeded weights (``params_from_reference``), the same
batches (numpy), the reference's tolerances.

Losses and gradients in f32 within 1e-4 of max|.| per leaf (the JAX
gradient tree goes through ``params_from_reference`` into the port's
layout); the bf16 loss within 2e-2, with the MoE router near ties of
``test_torch_lm_models`` left out.  The hierarchical step casts the
gradients to bf16 and sums the casts in f32: each synced gradient leaf
within 2**-7 of that leaf's max|g|.
"""
import functools
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data.tokens import TokenStream as RefStream
from repro.dist import sharding as jsh
from repro.models import lm as jlm
from repro.models import transformer as jt
from repro.opt import adam as jadam
from repro_torch.ckpt.checkpoint import restore, save
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.dist import sharding as tsh
from repro_torch.dist.fault import remesh
from repro_torch.launch import train as tcli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as tt
from repro_torch.opt import AdamW, leaves, sgd_momentum
from repro_torch.opt.tree import module_dict
from test_torch_lm_models import (
    B, MAX_TIED, T, TOL, configs, first_near_tie, inputs, positions,
)

WIRE = 2.0 ** -7  # one bf16 cast after adaptive normalization
_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _batch(cfg, seed=0, t=T):
    rng = np.random.default_rng(seed)
    return {"inputs": inputs(cfg, t, seed=seed),
            "labels": rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _models(name, dtype):
    jc, tc = configs(name, dtype, max_cache=T + 8, moe_capacity_factor=8.0)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    tp = tt.params_from_reference(jax.tree.map(np.asarray, jp), tc)
    return jc, tc, jp, tp


def _leaf_rel(got, want):
    """Max over leaves of max|got - want| / max|want|."""
    worst = 0.0
    for a, b in zip(got, want):
        a = np.asarray(a.detach().cpu() if torch.is_tensor(a) else a,
                       np.float32)
        b = np.asarray(b.detach().cpu() if torch.is_tensor(b) else b,
                       np.float32)
        assert a.shape == b.shape and np.isfinite(a).all()
        worst = max(worst, float(np.abs(a - b).max()
                                 / max(np.abs(b).max(), 1e-30)))
    return worst


# --------------------------------------------------------------------- #
# the loss and its gradients
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_and_grads_match_reference(name):
    """f32: ``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad`` of the reference's, within 1e-4."""
    jc, tc, jp, tp = _models(name, "f32")
    batch = _batch(jc)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jc, batch), has_aux=True))(jp)
    loss, metrics, grads = tlm._value_and_grad(tp, tc, batch)
    assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl))
    assert abs(float(metrics["nll"]) - float(jm["nll"])) <= 1e-4 * abs(
        float(jm["nll"]))
    assert abs(float(metrics["aux"]) - float(jm["aux"])) <= 1e-4 * max(
        abs(float(jm["aux"])), 1.0)
    want = leaves(tt.params_from_reference(jax.tree.map(np.asarray, jg), tc))
    assert len(grads) == len(want)
    assert _leaf_rel(grads, want) <= TOL["f32"], name
    # the caller's parameters stay frozen and hold no gradient
    assert not any(p.requires_grad or p.grad is not None
                   for p in tp.parameters())


def _token_nll(logits, labels):
    lg = np.asarray(logits, np.float64)[:, :-1]
    m = lg.max(-1, keepdims=True)
    lse = np.log(np.exp(lg - m).sum(-1)) + m[..., 0]
    tgt = np.take_along_axis(lg, labels[:, 1:, None], -1)[..., 0]
    return lse - tgt  # [B, T-1]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_bf16_loss_matches_reference(name):
    """The default bf16: the loss within 2e-2; where a MoE router meets a
    near tie, the per-token losses up to it."""
    jc, tc, jp, tp = _models(name, "bf16")
    batch = _batch(jc)
    jl, _ = jax.jit(lambda p: jlm.loss_fn(p, jc, batch))(jp)
    with torch.no_grad():
        loss, _ = tlm.loss_fn(tp, tc, batch)
    first = first_near_tie(tp, tc, batch["inputs"], "bf16")
    if (first >= T).all():
        assert abs(float(loss) - float(jl)) <= TOL["bf16"] * abs(float(jl))
        return
    keep = np.arange(T)[None, :] < first[:, None]
    assert keep.mean() >= 1 - MAX_TIED, first
    pos = positions(T)
    want = np.asarray(jax.jit(lambda p, x: jt.forward(
        p, jc, x, positions=pos, mode="train")[0])(jp, batch["inputs"]))
    with torch.no_grad():
        got = tt.forward(tp, tc, torch.from_numpy(batch["inputs"]),
                         positions=torch.from_numpy(pos))[0].numpy()
    a = _token_nll(got, batch["labels"])[keep[:, 1:]]
    b = _token_nll(want, batch["labels"])[keep[:, 1:]]
    assert abs(a.mean() - b.mean()) <= TOL["bf16"] * abs(b.mean())


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_step_shapes_and_finite(name):
    """``test_archs_smoke.py::test_train_step_shapes_and_finite`` on the
    port: a finite loss, logits [B, T, V], and one AdamW step that keeps
    every parameter finite and moves it."""
    cfg = get_config(name, smoke=True, max_cache=T + 8)
    gen = torch.Generator().manual_seed(0)
    params = tt.init_params(cfg, gen)
    batch = _batch(cfg, seed=4)
    opt = AdamW(lr=1e-3)
    step = tlm.make_train_step(cfg, opt)
    new, state, m = step(params, opt.init(params), batch)
    assert np.isfinite(float(m["loss"])), name
    assert int(state["count"]) == 1 and state["count"].dtype == torch.int32
    with torch.no_grad():
        logits, _, _ = tt.forward(params, cfg, torch.from_numpy(
            batch["inputs"]), positions=torch.from_numpy(positions(T)))
    assert tuple(logits.shape) == (B, T, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    moved = [not torch.equal(a, b) for a, b in zip(leaves(new),
                                                   leaves(params))]
    assert all(torch.isfinite(p).all() for p in leaves(new))
    assert sum(moved) >= len(moved) // 2
    assert type(new) is type(params) and all(
        p.requires_grad is False for p in leaves(new))


# --------------------------------------------------------------------- #
# the optimizers
# --------------------------------------------------------------------- #
def _opt_trees(seed=5):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    gs = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
           for k, s in shapes.items()} for _ in range(3)]
    return p, gs


@pytest.mark.parametrize("kind", ["adamw-clip", "adamw-wd-noclip", "sgd"])
def test_optimizer_matches_reference(kind):
    """Three updates of AdamW (global-norm clip; weight decay without
    clip) and of SGD with momentum, against the reference's, within 1e-6
    (f32)."""
    p, gs = _opt_trees()
    if kind == "adamw-clip":
        jo, to = jadam.AdamW(lr=1e-2), AdamW(lr=1e-2)
    elif kind == "adamw-wd-noclip":
        kw = dict(lr=3e-3, weight_decay=0.1, grad_clip=0.0)
        jo, to = jadam.AdamW(**kw), AdamW(**kw)
    else:
        jo, to = jadam.sgd_momentum(0.05, 0.8), sgd_momentum(0.05, 0.8)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in gs:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        assert _leaf_rel(leaves(tp), jax.tree.leaves(jp)) <= 1e-6
        assert _leaf_rel(leaves({k: v for k, v in ts.items()
                                 if k != "count"}),
                         jax.tree.leaves({k: v for k, v in js.items()
                                          if k != "count"})) <= 1e-6
    if "count" in js:
        assert int(ts["count"]) == int(js["count"]) == 3


def test_adamw_step_sane():
    """``test_lm_train.py::test_adamw_step_sane``: the first step moves by
    about ``lr`` against the gradient."""
    opt = AdamW(lr=0.1, grad_clip=0.0)
    params = {"w": torch.ones(4)}
    st = opt.init(params)
    new_p, st = opt.update({"w": torch.full((4,), 2.0)}, st, params)
    np.testing.assert_allclose(new_p["w"].numpy(), 1.0 - 0.1, atol=1e-3)
    assert torch.equal(params["w"], torch.ones(4))  # functional


# --------------------------------------------------------------------- #
# the reference's training tests, ported
# --------------------------------------------------------------------- #
def test_loss_decreases_smollm_smoke():
    """``test_lm_train.py::test_loss_decreases_smollm_smoke``: 25 AdamW
    steps at lr 1e-2 take the loss down by at least 0.5."""
    cfg = get_config("smollm-135m", smoke=True)
    opt = AdamW(lr=1e-2)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    opt_state = opt.init(params)
    step = tlm.make_train_step(cfg, opt)
    stream = TokenStream(cfg.vocab_size, 32, 8, seed=0)
    losses = []
    for s in range(25):
        params, opt_state, m = step(params, opt_state, stream.batch(s))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]


def _hier_case(mesh_shape=(1, 1, 1)):
    cfg = get_config("smollm-135m", smoke=True)
    jcfg = ref_config("smollm-135m", smoke=True)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(1))
    params = tt.params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    mesh = make_mesh(mesh_shape, ("pod", "data", "model"),
                     devices=["cpu"] * int(np.prod(mesh_shape)))
    batch = TokenStream(cfg.vocab_size, 16, 4, seed=1).batch(0)
    return cfg, jcfg, jp, params, mesh, batch


def test_hier_grad_sync_matches_spmd_single_device():
    """``test_lm_train.py::test_hier_grad_sync_matches_spmd_single_device``
    on the port: on a 1x1x1 mesh the hierarchical mixed-precision sync
    reproduces the plain step up to the bf16 cast (loss 1e-4,
    parameters 5e-3), each synced gradient within 2**-7 of its leaf's
    max|g|, and the reference's own hier step within the same bounds."""
    cfg, jcfg, jp, params, mesh, batch = _hier_case()
    opt = AdamW(lr=1e-3, grad_clip=0.0)
    p1, _, m1 = tlm.make_train_step(cfg, opt)(params, opt.init(params),
                                              batch)
    hier = tlm.make_hier_train_step(cfg, opt, mesh)
    p2, _, m2 = hier(params, opt.init(params), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p1), leaves(p2))) < 5e-3
    _, _, g_spmd = tlm._value_and_grad(params, cfg, batch)
    _, _, g_hier = hier.sync(params, batch)
    for a, b in zip(g_hier, g_spmd):
        assert float((a - b).abs().max()) <= WIRE * float(b.abs().max())
    # the reference's hier step on its own 1x1x1 mesh
    jmesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 3)
    jo = jadam.AdamW(lr=1e-3, grad_clip=0.0)
    jp2, _, jm2 = jax.jit(jlm.make_hier_train_step(jcfg, jo, jmesh))(
        jp, jo.init(jp), batch)
    assert abs(float(jm2["loss"]) - float(m2["loss"])) < 1e-4 * abs(
        float(jm2["loss"]))
    want = leaves(tt.params_from_reference(jax.tree.map(np.asarray, jp2),
                                           cfg))
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p2), want)) < 5e-3


def test_hier_step_on_a_2x2_mesh_matches_spmd():
    """Four data ranks on a (2, 2, 1) CPU mesh: the ladder's bytes per
    level for the f32 wire, and the step against the port's spmd step
    (the reference's multidevice bounds: loss 2e-3, parameters 5e-3;
    synced gradients within 2**-7 of max|g|)."""
    cfg, _, _, params, mesh, _ = _hier_case((2, 2, 1))
    batch = TokenStream(cfg.vocab_size, 16, 8, seed=2).batch(0)
    opt = AdamW(lr=1e-3, grad_clip=0.0)
    hier = tlm.make_hier_train_step(cfg, opt, mesh)
    assert hier.topology.n_data == 4
    assert [lv.axis for lv in hier.topology.levels] == ["data", "pod"]
    n = sum(p.numel() for p in leaves(params))
    assert hier.wire_dtype == torch.float32
    assert hier.plan.level_bytes(4 * n) == (4.0 * n, 2.0 * n)
    p1, _, m1 = tlm.make_train_step(cfg, opt)(params, opt.init(params),
                                              batch)
    p2, _, m2 = hier(params, opt.init(params), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-3
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p1), leaves(p2))) < 5e-3
    _, _, g_spmd = tlm._value_and_grad(params, cfg, batch)
    _, _, g_hier = hier.sync(params, batch)
    for a, b in zip(g_hier, g_spmd):
        assert float((a - b).abs().max()) <= WIRE * float(b.abs().max())


def test_hier_f32_wire_on_a_2x2_mesh():
    """The wire's rule, rank ``p`` = 2 * data + pod: the four ranks' bf16
    casts summed in f32 over the ladder, ``data`` pairs (0, 2) and
    (1, 3), then ``pod``, times ``inv / 4``, bit for bit."""
    from repro_torch.core.precision import qcast

    cfg, _, _, params, mesh, _ = _hier_case((2, 2, 1))
    batch = TokenStream(cfg.vocab_size, 16, 8, seed=2).batch(0)
    opt = AdamW(lr=1e-3, grad_clip=0.0)
    shards = [{k: v[2 * p:2 * p + 2] for k, v in batch.items()}
              for p in range(4)]
    ranks = [tlm._value_and_grad(params, cfg, sh)[2] for sh in shards]
    got = tlm.make_hier_train_step(cfg, opt, mesh).sync(params, batch)[2]
    for j in range(len(ranks[0])):
        c, inv = qcast([g[j] for g in ranks], torch.bfloat16, adaptive=True)
        f = [x.float() for x in c]
        want = ((f[0] + f[2]) + (f[1] + f[3])) * (inv[0] / 4)
        assert torch.equal(got[j], want), j


_REF_2X2 = """
import sys, numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.data.tokens import TokenStream
from repro.models.lm import make_hier_train_step
from repro.models.transformer import init_params
from repro.dist.sharding import param_specs, shardings
from repro.opt.adam import AdamW
cfg = get_config("smollm-135m", smoke=True)
opt = AdamW(lr=1e-3, grad_clip=0.0)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
    axis_types=(jax.sharding.AxisType.Auto,)*3)
params = init_params(cfg, jax.random.PRNGKey(0))
np.savez(sys.argv[1] + "_init.npz", *[np.asarray(x) for x in
         jax.tree.leaves(params)])
params = jax.device_put(params, shardings(param_specs(params, mesh), mesh))
batch = TokenStream(cfg.vocab_size, 16, 8, seed=2).batch(0)
batch = jax.device_put(batch, NamedSharding(mesh, P(("pod", "data"))))
p2, _, m2 = jax.jit(make_hier_train_step(cfg, opt, mesh))(
    params, opt.init(params), batch)
np.savez(sys.argv[1] + "_out.npz", float(m2["loss"]),
         *[np.asarray(x) for x in jax.tree.leaves(p2)])
"""


def test_hier_step_matches_reference_on_a_2x2_mesh():
    """The reference's hier step on a real 2x2x2 host mesh (8 XLA
    devices, in a subprocess as ``test_multidevice.py`` runs it; the
    ``model`` axis replicates there) against the port's on a (2, 2, 1)
    CPU mesh, from the same weights and batch: loss 2e-3, parameters
    5e-3, the bounds of ``test_hier_train_step_multidevice``."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = _SRC
    with tempfile.TemporaryDirectory() as d:
        stem = os.path.join(d, "ref")
        r = subprocess.run([sys.executable, "-c", _REF_2X2, stem],
                           capture_output=True, text=True, env=env,
                           timeout=600)
        assert r.returncode == 0, r.stderr
        init = np.load(stem + "_init.npz")
        out = np.load(stem + "_out.npz")
        init = [init[f"arr_{i}"] for i in range(len(init.files))]
        out = [out[f"arr_{i}"] for i in range(len(out.files))]
    jcfg = ref_config("smollm-135m", smoke=True)
    tree = jax.tree.unflatten(jax.tree.structure(
        jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0)))),
        init)
    cfg = get_config("smollm-135m", smoke=True)
    params = tt.params_from_reference(tree, cfg)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"),
                     devices=["cpu"] * 4)
    batch = TokenStream(cfg.vocab_size, 16, 8, seed=2).batch(0)
    opt = AdamW(lr=1e-3, grad_clip=0.0)
    p2, _, m2 = tlm.make_hier_train_step(cfg, opt, mesh)(
        params, opt.init(params), batch)
    assert abs(float(m2["loss"]) - float(out[0])) < 2e-3
    want = leaves(tt.params_from_reference(
        jax.tree.unflatten(jax.tree.structure(tree), out[1:]), cfg))
    assert max(float((a - torch.from_numpy(np.asarray(b))).abs().max())
               for a, b in zip(leaves(p2), want)) < 5e-3


# --------------------------------------------------------------------- #
# tokens
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("step,shards", [(0, 1), (7, 2), (123, 4),
                                         (1000, 1)])
def test_tokens_equal_reference(step, shards):
    """``test_data_and_fault.py``'s token cases: deterministic, and the
    reference's batches token for token."""
    s1 = TokenStream(512, 32, 8, seed=3, n_shards=shards)
    s2 = TokenStream(512, 32, 8, seed=3, n_shards=shards)
    b1, b2 = s1.batch(step), s2.batch(step)
    ref = RefStream(512, 32, 8, seed=3, n_shards=shards).batch(step)
    for k in ("inputs", "labels"):
        np.testing.assert_array_equal(b1[k], b2[k])
        np.testing.assert_array_equal(b1[k], ref[k])
        assert b1[k].dtype == ref[k].dtype == np.int32


def test_shard_recompute_equals_global():
    s = TokenStream(512, 16, 12, seed=1, n_shards=3)
    full = s.batch(7)["inputs"]
    for k in range(3):
        shard = s.shard_batch(7, k)["inputs"]
        np.testing.assert_array_equal(full[k * 4:(k + 1) * 4], shard)


def test_tokens_are_learnable():
    s = TokenStream(256, 128, 16, seed=0)
    b = s.batch(0)["inputs"]
    follow = (b[:, :-1] * 31 + 7) % max(8, 256 // 16)
    assert (b[:, 1:] == follow).mean() > 0.5


# --------------------------------------------------------------------- #
# specs and remesh
# --------------------------------------------------------------------- #
class _StubMesh:
    """The reference's spec functions read only ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = dict(zip(("pod", "data", "model"), shape))


def _ref_layer_specs(ref_specs, cfg):
    """The reference's spec tree in the port's layout: each scanned
    layer its slice's spec (the stacking entry dropped), attention's
    ``q_norm`` / ``k_norm`` flattened as ``params_from_reference`` does."""
    period = len(cfg.block_pattern)
    n_per, rem = divmod(cfg.n_layers, period)

    def block(tree, drop):
        out = {}
        for name, sub in tree.items():
            flat = {}
            for k, v in sub.items():
                if isinstance(v, dict):
                    for k2, v2 in v.items():
                        flat[f"{k}_{k2}"] = tuple(v2)[drop:] if tuple(
                            v2) else ()
                else:
                    flat[k] = tuple(v)[drop:] if tuple(v) else ()
            out[name] = flat
        return out

    layers = [block(ref_specs["scan"][f"l{j}"], 1)
              for _ in range(n_per) for j in range(period)]
    layers += [block(ref_specs["rem"][f"l{j}"], 0) for j in range(rem)]
    out = {k: tuple(ref_specs[k]) for k in ("embed", "unembed")
           if k in ref_specs}
    out["final_norm"] = {k: tuple(v)
                         for k, v in ref_specs["final_norm"].items()}
    out["layers"] = layers
    return out


def _norm(tree):
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_norm(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4)])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_specs_equal_reference(name, shape):
    """``param_specs`` (each layer its slice of the reference's stacked
    spec), ``batch_specs`` and ``cache_specs`` leaf for leaf."""
    jc, tc, jp, tp = _models(name, "f32")
    mesh = _StubMesh(shape)
    want = _ref_layer_specs(jsh.param_specs(jp, mesh), tc)
    assert _norm(tsh.param_specs(tp, mesh)) == want
    batch = {"inputs": inputs(jc, T), "labels": np.zeros((B, T), np.int32)}
    jb = jsh.batch_specs(batch, mesh)
    assert _norm(tsh.batch_specs(batch, mesh)) == {k: tuple(v)
                                                   for k, v in jb.items()}
    for b in (B, 8):
        jcache = jt.init_cache(jc, b)
        jspec = jsh.cache_specs(jcache, jc, mesh)
        tspec = tsh.cache_specs(tt.init_cache(tc, b), tc, mesh)
        period = len(tc.block_pattern)
        n_per = tc.n_layers // period
        for i, layer in enumerate(tspec):
            if i < n_per * period:
                ref = jspec["scan"][f"l{i % period}"]
                ref = {k: tuple(v)[1:] if tuple(v) else ()
                       for k, v in ref.items()}
            else:
                ref = {k: tuple(v) for k, v in
                       jspec["rem"][f"l{i - n_per * period}"].items()}
            assert _norm(layer) == ref, (i, layer, ref)


def test_remesh_checkpoint_roundtrip():
    """``test_multidevice.py::test_remesh_checkpoint_roundtrip`` on the
    port: parameters placed on a (2, 2, 2) mesh, saved, restored and
    ``remesh``-ed onto (1, 2, 4), bit for bit."""
    cfg = get_config("smollm-135m", smoke=True)
    params = tt.init_params(cfg, torch.Generator().manual_seed(3))
    mesh1 = make_mesh((2, 2, 2), ("pod", "data", "model"),
                      devices=["cpu"] * 8)
    mesh2 = make_mesh((1, 2, 4), ("pod", "data", "model"),
                      devices=["cpu"] * 8)
    p1 = remesh(params, tsh.param_specs(params, mesh1), mesh1)
    some_split = list(p1["layers"][0]["mix"].values())
    assert any(len({id(t) for t in x.pieces.flat}) > 1 for x in some_split)
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, p1)
        restored = restore(d, 1, p1)
    p2 = remesh(restored, tsh.param_specs(params, mesh2), mesh2)
    flat1 = leaves(p1)
    flat2 = leaves(p2)
    assert len(flat1) == len(flat2) == len(leaves(params))
    for a, b, c in zip(flat1, flat2, leaves(module_dict(params))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), c.detach().numpy())
    x = p2["layers"][0]["attn"]["wq"]
    assert x.pieces.shape == (1, 2, 4) and x.spec == (None, "model")
    assert tuple(x.pieces[0, 1, 3].shape) == (cfg.d_model,
                                               x.shape[1] // 4)


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
def _cli(*extra):
    return ["--arch", "smollm-135m", "--smoke", "--batch", "4", "--seq",
            "16", "--lr", "1e-2", "--device", "cpu", *extra]


def test_cli_trains_on_cpu(capsys):
    losses = tcli.main(_cli("--steps", "12", "--log-every", "4"))
    assert len(losses) == 12 and losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "suggested ckpt period @1000 nodes" in out
    assert out.strip().splitlines()[-1].startswith(
        f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


def test_cli_hier_prints_the_ladder(capsys):
    losses = tcli.main(_cli("--steps", "3", "--grad-comm", "hier"))
    out = capsys.readouterr().out
    assert "Topology over 1 devices" in out and "CommPlan(mode='hier')" in out
    assert "axis 'data'" in out and "axis 'pod'" in out
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_cli_resume_equals_an_uninterrupted_run(capsys):
    """``--ckpt-dir``: 4 steps saved every 2, then a run to 6 resumes from
    step 4 and ends on the parameters of an uninterrupted 6-step run."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        tcli.main(_cli("--steps", "4", "--ckpt-dir", d1, "--ckpt-every",
                       "2"))
        resumed = tcli.main(_cli("--steps", "6", "--ckpt-dir", d1,
                                 "--ckpt-every", "2"))
        assert "resumed from step 4" in capsys.readouterr().out
        straight = tcli.main(_cli("--steps", "6", "--ckpt-dir", d2,
                                  "--ckpt-every", "2"))
        assert resumed == straight[4:]
        cfg = get_config("smollm-135m", smoke=True)
        params = tt.init_params(cfg, torch.Generator().manual_seed(0))
        opt = AdamW()
        like = tcli.state_tree(params, opt.init(params), 0)
        a = restore(d1, 6, like)
        b = restore(d2, 6, like)
        for x, y in zip(leaves(a), leaves(b)):
            np.testing.assert_array_equal(x, y)


def test_cli_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])


def test_cli_exits_non_zero_without_a_card():
    """``python -m repro_torch.launch.train`` with no card and no
    ``--device cpu`` fails; it never falls back to the CPU."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--smoke", "--steps", "1"], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode != 0 and "CUDA" in r.stderr
    assert "step" not in r.stdout


def test_serving_builds_no_graph_and_training_does():
    """The forward is differentiable, yet serving's frozen parameters and
    its ``no_grad`` heads build no autograd graph; the train step's live
    copy does, and leaves the caller's parameters untouched."""
    cfg = get_config("qwen3-4b", smoke=True, max_cache=T + 8)
    params = tt.init_params(cfg, torch.Generator().manual_seed(5))
    x = torch.from_numpy(inputs(cfg, T + 1, seed=5))
    pos = torch.from_numpy(positions(T + 1))
    logits, _, _ = tt.forward(params, cfg, x, positions=pos)
    assert logits.grad_fn is None and not logits.requires_grad
    last, cache = tlm.prefill(params, cfg, x[:, :T])
    _, _, dec = tlm.decode_step(params, cfg, cache, x[:, T:], T)
    assert last.grad_fn is None and dec.grad_fn is None
    assert all(c["k"].grad_fn is None for c in cache)
    live = tlm._live(params)
    out, _, _ = tt.forward(live, cfg, x, positions=pos)
    assert out.grad_fn is not None
    assert all(p.requires_grad for p in leaves(live))
    assert not any(p.requires_grad for p in leaves(params))
