"""Tensor parallelism over ``model`` in the PyTorch port
(``dist.sharding.place_state``, ``dist.collectives.ModelGroup``,
``models.transformer.forward_group``, the split train steps, ``prefill``
and ``decode_step`` on a laid-out state, checkpoints and ``remesh``) on
CPU meshes at SMOKE width, against the port on one device and against
the JAX package's GSPMD step.

``model`` = 2 for every arch (smollm-135m's 3 heads then take the
query-row split), and 4 for qwen3-4b (its 2 kv heads are then computed
on two ranks each).  Tolerances: the split against one device, f32,
the loss and every gradient leaf within 1e-4 of max|g| (the bound
``test_torch_lm_train.py`` holds against ``jax.value_and_grad``), the
bf16 loss within 2e-2, serving
logits within 1e-5 of max|logit| with the same greedy tokens; against
the reference's jitted step on 2 or 4 XLA host devices, the loss within
2e-3 and the parameters within 5e-3 (its multidevice bounds).
"""
import functools
import json
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import transformer as jt
from repro_torch import placement
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.dist import sharding as tsh
from repro_torch.dist.fault import remesh
from repro_torch.launch import train as tcli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as tt
from repro_torch.opt import AdamW, leaves, sgd_momentum

B, T = 2, 16
GRAD_TOL = 1e-4
BF16_LOSS = 2e-2
LOGIT_TOL = 1e-5
REF_LOSS, REF_PARAMS = 2e-3, 5e-3
WIRE = 2.0 ** -7  # one bf16 cast after adaptive normalization
CASES = [(a, 2) for a in ARCH_NAMES] + [("qwen3-4b", 4)]
REF_CASES = [("qwen3-4b", 2), ("qwen3-4b", 4), ("smollm-135m", 2),
             ("moonshot-v1-16b-a3b", 2), ("recurrentgemma-9b", 2)]
_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MOVES = {"scatter", "all-reduce", "all-gather", "all-to-all",
         "reduce-scatter", "pmax", "pmean", "psum"}


def _cfg(name, dtype=torch.float32, **kw):
    return get_config(name, smoke=True, activation_dtype=dtype,
                      cache_dtype=dtype, moe_capacity_factor=8.0, **kw)


@functools.lru_cache(maxsize=None)
def _params(name):
    return tt.init_params(_cfg(name), torch.Generator().manual_seed(0))


def _batch(cfg, seed=0, b=B, t=T):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        x = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int64)
    else:
        x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    return {"inputs": x,
            "labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int64)}


def _mesh(shape):
    return make_mesh(shape, ("pod", "data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))


def _rel(got, want):
    """Max over leaves of max|got - want| / max|want|."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.detach().float(), b.detach().float()
        assert a.shape == b.shape and torch.isfinite(a).all()
        worst = max(worst, float((a - b).abs().max()
                                 / max(float(b.abs().max()), 1e-30)))
    return worst


# --------------------------------------------------------------------- #
# (b) the split spmd step against one device
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,m", CASES)
def test_split_step_matches_one_device(name, m):
    """Loss and every gradient leaf of the spmd step split over ``model``
    within 1e-4 of max|g| of the one-device step's, f32; the updated
    parameters within 5e-3 (AdamW's first step is ``lr`` times the sign
    of a gradient, which rounding may flip where it is near zero)."""
    cfg, params = _cfg(name), _params(name)
    batch = _batch(cfg)
    loss1, _, g1 = tlm._value_and_grad(params, cfg, batch)
    opt = AdamW(lr=1e-3)
    step = tlm.make_train_step(cfg, opt, _mesh((1, 1, m)))
    loss2, _, g2 = step.sync(params, batch)
    assert abs(float(loss1) - float(loss2)) <= GRAD_TOL * abs(float(loss1))
    assert _rel(g2, g1) <= GRAD_TOL
    p1, _, _ = tlm.make_train_step(cfg, opt)(params, opt.init(params), batch)
    p2, _, _ = step(params, opt.init(params), batch)
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p2), leaves(p1))) < REF_PARAMS


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_split_bf16_loss_matches_one_device(name):
    cfg = _cfg(name, torch.bfloat16)
    params = _params(name)
    batch = _batch(cfg)
    loss1 = tlm._value_and_grad(params, cfg, batch)[0]
    step = tlm.make_train_step(cfg, AdamW(), _mesh((1, 1, 2)))
    loss2 = step.sync(params, batch)[0]
    assert abs(float(loss1) - float(loss2)) <= BF16_LOSS * abs(float(loss1))


def test_attention_splits():
    """By heads where they divide (kv heads shared by the ranks that read
    them), by query rows where they do not."""
    from repro_torch.models.layers import attn_split

    how, q, kv = attn_split(_cfg("qwen3-4b"), 4)  # 4 heads, 2 kv heads
    assert how == "heads" and q == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert kv == [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert attn_split(_cfg("smollm-135m"), 2)[0] == "rows"  # 3 heads
    assert attn_split(get_config("qwen2-vl-7b"), 16)[0] == "rows"  # 28
    assert attn_split(get_config("deepseek-coder-33b"), 16)[0] == "rows"
    assert attn_split(get_config("qwen3-4b"), 16)[0] == "heads"


# --------------------------------------------------------------------- #
# (d) the hier step, split against unsplit
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["qwen3-4b", "smollm-135m",
                                  "recurrentgemma-9b"])
def test_hier_step_split_matches_unsplit(name):
    """The hier step on (1, 2, 2) against the port's on (1, 2, 1): with
    an f32 wire, the loss, the synced gradients and the parameters after
    an SGD step (linear in the gradients, piece by piece) within 1e-5;
    with the bf16 wire (one factor per leaf over its model pieces and the
    data ranks) the synced gradients within 2**-7 of max|g|."""
    cfg, params = _cfg(name), _params(name)
    batch = _batch(cfg, b=4)
    opt = sgd_momentum(lr=1e-2)
    for wire, tol in ((torch.float32, 1e-5), (torch.bfloat16, WIRE)):
        one = tlm.make_hier_train_step(cfg, opt, _mesh((1, 2, 1)),
                                       comm_dtype=wire)
        two = tlm.make_hier_train_step(cfg, opt, _mesh((1, 2, 2)),
                                       comm_dtype=wire)
        l1, _, g1 = one.sync(params, batch)
        l2, _, g2 = two.sync(params, batch)
        assert abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l1))
        assert _rel(g2, g1) <= tol
        if wire == torch.float32:
            p1 = one(params, opt.init(params), batch)[0]
            p2 = two(params, opt.init(params), batch)[0]
            assert _rel(leaves(p2), leaves(p1)) <= tol


# --------------------------------------------------------------------- #
# (a) the layout, against the reference's NamedSharding
# --------------------------------------------------------------------- #
_REF = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.data.tokens import TokenStream
from repro.dist.sharding import param_specs, shardings
from repro.models.lm import make_train_step
from repro.models.transformer import init_params
from repro.opt.adam import AdamW

stem, cases = sys.argv[1], json.loads(sys.argv[2])
for name, m in cases:
    cfg = get_config(name, smoke=True, activation_dtype=jnp.float32,
                     cache_dtype=jnp.float32, moe_capacity_factor=8.0)
    mesh = jax.make_mesh((1, 1, m), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3,
                         devices=jax.devices()[:m])
    params = init_params(cfg, jax.random.PRNGKey(0))
    specs = param_specs(params, mesh)
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    # moments of distinct values, so that each slice is its own
    state = {"m": jax.tree.map(lambda x: 2.0 * x + 1.0, params),
             "v": jax.tree.map(lambda x: x * x, params),
             "count": state["count"]}
    ospecs = {"m": specs, "v": specs, "count": P()}
    placed = jax.device_put(params, shardings(specs, mesh))
    ostate = jax.device_put(state, shardings(ospecs, mesh))
    out = {"whole": [np.asarray(x) for x in jax.tree.leaves(params)]}
    order = [d.id for d in mesh.devices.flat]
    for tag, tree in (("p", placed), ("m", ostate["m"]),
                      ("v", ostate["v"])):
        for leaf_i, leaf in enumerate(jax.tree.leaves(tree)):
            for sh in leaf.addressable_shards:
                pos = order.index(sh.device.id)
                out.setdefault(f"{tag}{pos}", []).append(
                    (leaf_i, np.asarray(sh.data)))
    batch = TokenStream(cfg.vocab_size, 16, 4, seed=3).batch(0)
    opt0 = jax.device_put(opt.init(params),
                          shardings({"m": specs, "v": specs, "count": P()},
                                    mesh))
    p2, _, m2 = jax.jit(make_train_step(cfg, opt))(placed, opt0, batch)
    flat = {"loss": np.float32(m2["loss"])}
    for k, v in out.items():
        if k == "whole":
            for i, x in enumerate(v):
                flat[f"whole_{i}"] = x
        else:
            for j, (leaf_i, x) in enumerate(v):
                flat[f"{k}_{leaf_i}"] = x
    for i, x in enumerate(jax.tree.leaves(p2)):
        flat[f"out_{i}"] = np.asarray(x)
    np.savez(f"{stem}_{name}_{m}.npz", **flat)
"""


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's layouts and jitted steps, in one subprocess with
    4 XLA host devices (``test_multidevice.py``'s way)."""
    stem = str(tmp_path_factory.mktemp("tp") / "ref")
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", _REF, stem,
                        json.dumps(REF_CASES)],
                       capture_output=True, text=True, env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]

    def load(name, m):
        data = np.load(f"{stem}_{name}_{m}.npz")
        return {k: data[k] for k in data.files}

    return load


def _ref_tree(name, arrays):
    jcfg = ref_config(name, smoke=True)
    struct = jax.tree.structure(jax.eval_shape(
        lambda: jt.init_params(jcfg, jax.random.PRNGKey(0))))
    return jax.tree.unflatten(struct, arrays)


def _port(name, tree):
    return tt.params_from_reference(tree, _cfg(name))


@pytest.mark.parametrize("name,m", REF_CASES)
def test_layout_equals_the_reference_shards(ref_runs, name, m):
    """(a) Every position's piece of every parameter and of both moments
    has the shape of the reference device's shard at that position, and
    its values, bit for bit."""
    got = ref_runs(name, m)
    n = sum(1 for k in got if k.startswith("whole_"))
    whole = [got[f"whole_{i}"] for i in range(n)]
    params = _port(name, _ref_tree(name, whole))
    m_tree = _port(name, _ref_tree(name, [2.0 * x + 1.0 for x in whole]))
    v_tree = _port(name, _ref_tree(name, [x * x for x in whole]))
    mesh = _mesh((1, 1, m))
    state = {"m": m_tree, "v": v_tree,
             "count": torch.zeros((), dtype=torch.int32)}
    pp, po = tsh.place_state(params, state, mesh)
    for pos in range(m):
        idx = (0, 0, pos)
        for tag, placed in (("p", pp), ("m", po["m"]), ("v", po["v"])):
            shards = [got[f"{tag}{pos}_{i}"] for i in range(n)]
            want = leaves(_port(name, _ref_tree(name, shards)))
            for pl, w in zip(placed.leaves, want):
                piece = pl.pieces[idx]
                assert tuple(piece.shape) == tuple(w.shape), (tag, pos)
                assert torch.equal(piece, w), (tag, pos)
    split = sum(1 for pl in pp.leaves if pl.model_dim() is not None)
    assert split > 0


@pytest.mark.parametrize("name,m", REF_CASES)
def test_split_step_matches_the_reference_gspmd_step(ref_runs, name, m):
    """(c) The reference's jitted spmd step, its parameters and AdamW
    state placed by ``shardings(param_specs)`` on ``m`` XLA host devices,
    against the port's split step on a (1, 1, m) CPU mesh from the same
    weights and batch: loss 2e-3, parameters 5e-3."""
    from repro_torch.data.tokens import TokenStream

    got = ref_runs(name, m)
    n = sum(1 for k in got if k.startswith("whole_"))
    params = _port(name, _ref_tree(name, [got[f"whole_{i}"]
                                          for i in range(n)]))
    cfg = _cfg(name)
    batch = TokenStream(cfg.vocab_size, 16, 4, seed=3).batch(0)
    opt = AdamW(lr=1e-3)
    p2, _, m2 = tlm.make_train_step(cfg, opt, _mesh((1, 1, m)))(
        params, opt.init(params), batch)
    assert abs(float(m2["loss"]) - float(got["loss"])) < REF_LOSS
    want = leaves(_port(name, _ref_tree(name, [got[f"out_{i}"]
                                               for i in range(n)])))
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p2), want)) < REF_PARAMS


# --------------------------------------------------------------------- #
# (e) the state stays laid out across steps, and no replicate copy
# --------------------------------------------------------------------- #
class _Tags:
    """Records every ``copy_kind`` tag entered."""

    def __init__(self, var):
        self.var, self.seen = var, set()

    def set(self, kind):
        self.seen.add(kind)
        return self.var.set(kind)

    def reset(self, token):
        return self.var.reset(token)

    def get(self):
        return self.var.get()


@pytest.mark.parametrize("step_kind", ["hier", "spmd"])
def test_state_stays_laid_out_and_sends_no_replicate(monkeypatch, step_kind):
    """Three steps on a (1, 2, 2) mesh from a laid-out state: every
    position still holds its spec's piece of every parameter and both
    moments, the steps tag no ``"replicate"`` copy, and every tag they
    enter is a collective's."""
    cfg, params = _cfg("qwen3-4b"), _params("qwen3-4b")
    mesh = _mesh((1, 2, 2))
    opt = AdamW(lr=1e-3)
    pp, po = tsh.place_state(params, opt.init(params), mesh)
    shapes = [[tuple(p.shape) for p in pl.pieces.flat] for pl in pp.leaves]
    make = (tlm.make_hier_train_step if step_kind == "hier"
            else tlm.make_train_step)
    step = make(cfg, opt, mesh)
    tags = _Tags(placement._KIND)
    monkeypatch.setattr(placement, "_KIND", tags)
    for i in range(3):
        pp, po, _ = step(pp, po, _batch(cfg, seed=i, b=4))
    monkeypatch.undo()
    assert "replicate" not in tags.seen
    assert tags.seen <= MOVES, tags.seen
    specs = tsh.param_specs(params, mesh)
    for tree in (pp, po["m"], po["v"]):
        assert isinstance(tree, tsh.PlacedTree)
        for pl, want in zip(tree.leaves, shapes):
            assert [tuple(p.shape) for p in pl.pieces.flat] == want
    assert [pl.spec for pl in pp.leaves] == [
        tsh._path_spec(specs, n) for n, _ in params.named_parameters()]
    assert int(po["count"].full()) == 3


def test_clip_counts_each_element_once():
    """AdamW's global-norm clip on a laid-out state equals the one-device
    update's (a replicated leaf's pieces are not summed per rank)."""
    cfg, params = _cfg("smollm-135m"), _params("smollm-135m")
    batch = _batch(cfg)
    opt = AdamW(lr=1e-2, grad_clip=1e-3)
    p1 = tlm.make_train_step(cfg, opt)(params, opt.init(params), batch)[0]
    p2 = tlm.make_train_step(cfg, opt, _mesh((1, 2, 2)))(
        params, opt.init(params), _batch(cfg))[0]
    assert _rel(leaves(p2), leaves(p1)) <= GRAD_TOL


# --------------------------------------------------------------------- #
# (f) serving
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,m", CASES)
def test_split_prefill_and_greedy_decode_match_one_device(name, m):
    """``prefill`` plus 8 greedy decode steps on a (1, 1, m) layout
    against one device: f32 logits within 1e-5 of max|logit|, and the
    same tokens."""
    cfg = _cfg(name, max_cache=T + 8)
    params = _params(name)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_batch(cfg, seed=1, t=T // 2)["inputs"])
    pp, _ = tsh.place_state(params, None, _mesh((1, 1, m)))
    l1, c1 = tlm.prefill(params, cfg, x)
    l2, c2 = tlm.prefill(pp, cfg, x)
    worst = float((l1 - l2).abs().max() / l1.abs().max())
    t1 = t2 = torch.argmax(l1, -1, keepdim=True).to(torch.int32)
    for i in range(8):
        if cfg.embed_inputs:
            a1, a2 = t1, t2
        else:
            a1 = a2 = torch.from_numpy(rng.standard_normal(
                (B, 1, cfg.d_model)).astype(np.float32))
        t1, c1, g1 = tlm.decode_step(params, cfg, c1, a1, T // 2 + i)
        t2, c2, g2 = tlm.decode_step(pp, cfg, c2, a2, T // 2 + i)
        worst = max(worst, float((g1 - g2).abs().max() / g1.abs().max()))
        assert torch.equal(t1, t2), i
    assert worst <= LOGIT_TOL


def test_split_cache_holds_each_ranks_heads():
    """A split prefill's cache: rank r's kv heads where attention splits
    by heads (qwen3-4b, 2 kv heads on 4 ranks: one each), every head
    where it splits by rows (smollm-135m)."""
    for name, m, heads in (("qwen3-4b", 4, 1), ("smollm-135m", 2, 1)):
        cfg = _cfg(name, max_cache=T)
        pp, _ = tsh.place_state(_params(name), None, _mesh((1, 1, m)))
        _, cache = tlm.prefill(pp, cfg, torch.from_numpy(
            _batch(cfg, t=8)["inputs"]))
        assert len(cache) == m
        for rank in cache:
            assert rank[0]["k"].shape == (B, T, heads, cfg.head_dim)


# --------------------------------------------------------------------- #
# (g) checkpoints across meshes
# --------------------------------------------------------------------- #
def test_checkpoint_from_a_split_mesh_restores_on_others():
    """A checkpoint saved from (1, 1, 2) (its pieces joined) restored on
    (1, 1, 1) and on (1, 2, 2), each laid out there, bit for bit; and
    ``remesh`` moves the state between the meshes, bit for bit."""
    from repro_torch.ckpt.checkpoint import restore, save

    cfg, params = _cfg("qwen3-4b"), _params("qwen3-4b")
    opt = AdamW(lr=1e-3)
    pp, po = tsh.place_state(params, opt.init(params), _mesh((1, 1, 2)))
    pp, po, _ = tlm.make_train_step(cfg, opt, pp.mesh)(pp, po, _batch(cfg))
    whole = tcli.state_tree(pp, po, 1)
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, whole)
        for shape in ((1, 1, 1), (1, 2, 2)):
            mesh = _mesh(shape)
            tp, to = tsh.place_state(params, opt.init(params), mesh)
            tree = restore(d, 1, tcli.state_tree(tp, to, 0), device="cpu")
            rp, ro, step = tcli.load_state(tree, tp, to)
            assert step == 1 and rp.mesh is mesh
            got = tcli.state_tree(rp, ro, 1)
            for a, b in zip(leaves(got), leaves(whole)):
                assert torch.equal(a, b)
            moved = remesh(pp, None, mesh)
            for a, b in zip(moved.leaves, rp.leaves):
                assert a.spec == b.spec
                for x, y in zip(a.pieces.flat, b.pieces.flat):
                    assert torch.equal(x, y)
            mo = remesh(po, None, mesh)
            assert int(mo["count"].full()) == 1


def test_cli_trains_split_on_a_cpu_mesh(monkeypatch, capsys):
    """The CLI on a (1, 1, 2) CPU mesh prints each position's bytes and
    trains: the loss falls."""
    monkeypatch.setattr(tcli, "make_device_mesh",
                        lambda device: _mesh((1, 1, 2)))
    losses = tcli.main(["--arch", "smollm-135m", "--smoke", "--steps", "12",
                        "--batch", "4", "--seq", "16", "--lr", "1e-2",
                        "--device", "cpu", "--log-every", "4"])
    out = capsys.readouterr().out
    assert "split over 'model'" in out and "(0, 0, 1):" in out
    assert losses[-1] < losses[0]
