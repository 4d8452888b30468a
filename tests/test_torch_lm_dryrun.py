"""The LM cells of the port's dry run (``launch/dryrun.py``'s
``lower_lm_cell`` and its helpers, ``launch/hlo_analysis.py``'s
``analytic_min_hbm``) against the JAX package on the CPU, and the
trace's own numbers against what they must be.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 placeholder devices
when it is imported, so every number of the reference's dry run is
computed in one subprocess (``_REF_SIDE``), started with the module's
first case and read when a case needs it.  ``analytic_min_hbm`` needs no
devices and is compared in this process.

The cells here are SMOKE widths on small fake meshes (``model`` = 1, 2
or 4), so that each traces in a second or two.
"""
import json
import os
import subprocess
import sys
import types

import pytest

from repro.configs import get_config as ref_config
from repro.launch import hlo_analysis as jhlo
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_fake_mesh

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KINDS = ("train", "prefill", "decode")
DPS = (("data",), ("pod", "data"))
MESHES = {"16x16": ({"data": 16, "model": 16}, 256),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}, 512)}
# the SMOKE train cell held against the reference's compiled one
ARG_CELL = dict(arch="smollm-135m", seq=32, batch=8, n_data=4,
                models=[1, 2])

_REF_SIDE = r"""
import json, sys
from repro.launch import dryrun  # XLA_FLAGS: 512 placeholder devices
import jax
from repro.configs import ARCH_NAMES, SHAPES, get_config

path, cell = sys.argv[1], json.loads(sys.argv[2])
out = {"DP_AXES": list(dryrun.DP_AXES), "hints": {}, "useful": {},
       "recurrent": {}}
for arch in ARCH_NAMES:
    for dp in (("data",), ("pod", "data")):
        for kind in ("train", "prefill", "decode"):
            out["hints"][f"{arch}|{','.join(dp)}|{kind}"] = \
                dryrun._hint_overrides(arch, dp, kind)
    for shape, (seq, batch, kind) in SHAPES.items():
        cfg = get_config(arch, max_cache=seq,
                         remat="full" if kind == "train" else "none")
        tokens = batch * seq if kind != "decode" else batch
        for n_dev in (256, 512):
            out["useful"][f"{arch}|{shape}|{n_dev}"] = \
                dryrun._useful_flops(cfg, kind, tokens, n_dev)
        out["recurrent"][f"{arch}|{shape}"] = \
            dryrun._recurrent_flops_correction(cfg, kind, batch, seq)
# a SMOKE train cell on a (data, model) mesh of host devices, compiled
out["arg_bytes"] = {}
for m in cell["models"]:
    mesh = jax.make_mesh((cell["n_data"], m), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:cell["n_data"] * m])
    cfg = get_config(cell["arch"], smoke=True, max_cache=cell["seq"],
                     remat="full")
    fn, args, _ = dryrun._build_cell(cfg, "train", cell["seq"],
                                     cell["batch"], mesh, ("data",))
    with mesh:
        compiled = fn.lower(*args).compile()
    out["arg_bytes"][str(m)] = int(
        compiled.memory_analysis().argument_size_in_bytes)
with open(path, "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """The reference's numbers, from a subprocess that runs beside the
    port's cases until the first one reads them."""
    path = tmp_path_factory.mktemp("ref") / "out.json"
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SIDE, str(path), json.dumps(ARG_CELL)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    cache = {}

    def get(key):
        if not cache:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
            cache.update(json.loads(path.read_text()))
        return cache[key]

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _same(a, b, skip=("trace_s",)):
    """Two records equal but for ``skip`` (at any depth)."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k not in skip}
        return x
    assert strip(a) == strip(b)


# --------------------------------------------------------------------- #
# analytic_min_hbm, the hints and the FLOP models
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_analytic_min_hbm_equals_the_reference(arch, mesh):
    shape, size = MESHES[mesh]
    m = types.SimpleNamespace(shape=shape, size=size)
    for seq, batch, kind in SHAPES.values():
        for k in KINDS:
            got = hlo_analysis.analytic_min_hbm(
                get_config(arch, max_cache=seq), k, batch, seq, m)
            want = jhlo.analytic_min_hbm(
                ref_config(arch, max_cache=seq), k, batch, seq, m)
            assert got == want, (arch, mesh, seq, k)


def test_analytic_hbm_monotone_in_batch():
    cfg = get_config("qwen3-4b", max_cache=1024)
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16}, size=256)
    small = hlo_analysis.analytic_min_hbm(cfg, "train", 16, 1024, mesh)
    big = hlo_analysis.analytic_min_hbm(cfg, "train", 64, 1024, mesh)
    assert big > small > 0


def test_hint_rules():
    # kv divides -> no q-shard, no merge
    ov = dryrun._hint_overrides("codeqwen1.5-7b", ("data",), "train")
    assert not ov["attn_q_shard"] and not ov["attn_heads_merge"]
    # prefill with indivisible kv -> q-shard
    ov = dryrun._hint_overrides("deepseek-coder-33b", ("data",), "prefill")
    assert ov["attn_q_shard"]
    # train with divisible total heads -> merge
    ov = dryrun._hint_overrides("qwen3-4b", ("data",), "train")
    assert ov["attn_heads_merge"] and not ov["attn_q_shard"]
    # MQA -> q-shard even in train
    ov = dryrun._hint_overrides("recurrentgemma-9b", ("data",), "train")
    assert ov["attn_q_shard"]


def test_names_of_the_reference_module():
    assert hlo_analysis.HW is dryrun.hardware.HW
    assert hlo_analysis.roofline is dryrun.roofline
    assert not hasattr(hlo_analysis, "analyze_collectives")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_helpers_equal_the_reference(arch, ref):
    assert list(dryrun.DP_AXES) == ref("DP_AXES")
    for dp in DPS:
        for kind in KINDS:
            got = dryrun._hint_overrides(arch, dp, kind)
            want = ref("hints")[f"{arch}|{','.join(dp)}|{kind}"]
            assert {**got, "dp_axes": list(got["dp_axes"])} == want
    for shape, (seq, batch, kind) in SHAPES.items():
        cfg = get_config(arch, max_cache=seq,
                         remat="full" if kind == "train" else "none")
        tokens = batch * seq if kind != "decode" else batch
        for n_dev in (256, 512):
            assert dryrun._useful_flops(cfg, kind, tokens, n_dev) == \
                ref("useful")[f"{arch}|{shape}|{n_dev}"]
        assert dryrun._recurrent_flops_correction(cfg, kind, batch, seq) \
            == ref("recurrent")[f"{arch}|{shape}"]


# --------------------------------------------------------------------- #
# traced cells
# --------------------------------------------------------------------- #
def _cell(arch, shape, mesh_shape, names, seq, batch, **kw):
    return dryrun.lower_lm_cell(
        arch, shape, False, smoke=True, mesh=make_fake_mesh(mesh_shape,
                                                            names),
        seq=seq, batch=batch, **kw)


@pytest.mark.parametrize("m", ARG_CELL["models"])
def test_smoke_train_cell_argument_bytes_against_the_reference(ref, m):
    """Rank 0 holds its pieces of the parameters and of AdamW's state,
    as the reference's device at its position does (``model`` = 1: all
    of them; ``model`` = 2: the pieces ``param_specs`` gives it), and the
    whole batch, of which each reference device holds its
    ``1 / n_data``; every other rank holds its own pieces."""
    c = ARG_CELL
    rec = _cell(c["arch"], "train_4k", (c["n_data"], m), ("data", "model"),
                c["seq"], c["batch"])
    assert rec["status"] == "ok"
    batch_bytes = c["batch"] * c["seq"] * 4 * 2  # int32 inputs + labels
    per_dev = batch_bytes // c["n_data"]
    want = ref("arg_bytes")[str(m)]
    assert rec["memory"]["rank0"]["argument"] == \
        want - per_dev + batch_bytes
    assert rec["cell"]["ranks"] == c["n_data"] * m


def test_traced_flops_of_a_dense_cell_equal_the_closed_form():
    """smollm-135m SMOKE (2 layers, one-layer period, tied embeddings),
    one hier train step on two ranks: each rank's matrix products,
    forward (q, k, v, o, the gated MLP's three, both attention
    contractions, the unembed) and backward (two products of each);
    under ``remat="full"`` also the recompute of every layer (every
    period is full) but its last product, the MLP's down projection,
    whose output no backward reads (``checkpoint`` stops its recompute
    once the backward's tensors are back)."""
    seq, batch, ranks = 16, 4, 2
    cfg = get_config("smollm-135m", smoke=True)
    n = batch // ranks * seq  # tokens a rank
    d, hd, f, v = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.vocab_size
    h, kv = cfg.n_heads, cfg.n_kv_heads
    layer = (2 * n * d * h * hd + 2 * 2 * n * d * kv * hd
             + 2 * n * h * hd * d + 3 * 2 * n * d * f
             + 2 * 2 * (batch // ranks) * h * seq * seq * hd)
    forward = cfg.n_layers * layer + 2 * n * d * v
    recompute = cfg.n_layers * (layer - 2 * n * f * d)
    kw = dict(arch="smollm-135m", shape="train_4k", mesh_shape=(ranks, 1),
              names=("data", "model"), seq=seq, batch=batch)
    assert _cell(**kw)["flops_per_dev"] == 3 * forward + recompute
    none = _cell(**kw, overrides={"remat": "none"})
    assert none["flops_per_dev"] == 3 * forward


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_time_fd_equals_a_full_trace(shape):
    """xlstm-350m SMOKE at 32 steps: the extrapolation from 8, 16 and 24
    (``FD_STEPS``) equals the trace of every step, count for count."""
    kw = dict(arch="xlstm-350m", shape=shape, mesh_shape=(2, 1),
              names=("data", "model"), seq=32, batch=4,
              overrides={"n_layers": 2})
    fd = _cell(**kw)
    full = _cell(**kw, fd_cost=False)
    assert fd["cost_source"] == "fd(time: 8, 16, 24)"
    assert full["cost_source"] == "trace(every layer)"
    _same(fd, full, skip=("trace_s", "cost_source"))


@pytest.mark.parametrize("arch,m", [("smollm-135m", 1), ("smollm-135m", 4),
                                    ("qwen3-4b", 4)])
def test_rank_replay_equals_every_rank_traced(arch, m):
    """On a (pod 2, data 2, model m) mesh, data ranks 2 and 3 replaying
    rank 1's loss and backward, and (m = 4) model rank 3 a phantom whose
    numbers are model rank 1's, give the numbers of every rank traced:
    memory per rank, FLOPs and every copy alike.  The one exception is
    the busiest device's unfused bytes (``hbm_bytes_per_dev``, and the
    roofline's terms), within 5%: a live rank does not add up the
    gradients a phantom would send back (their copies are counted), and
    even traced in full the ranks of a group differ by a few tenths of a
    percent, adding their gradients' pieces in different orders."""
    kw = dict(arch=arch, shape="train_4k", mesh_shape=(2, 2, m),
              names=("pod", "data", "model"), seq=16, batch=8)
    fast = _cell(**kw)
    full = _cell(**kw, replay=False)
    assert fast["cell"]["ranks_replayed"] == 2
    assert full["cell"]["ranks_traced"] == 4
    assert fast["collectives"]["dci_bytes"] > 0
    skip = ("trace_s", "ranks_traced", "ranks_replayed")
    if m > 3:
        skip += ("hbm_bytes_per_dev", "memory")
        a, b = fast["hbm_bytes_per_dev"], full["hbm_bytes_per_dev"]
        assert abs(a - b) <= 0.05 * b
        _same(fast["memory"], full["memory"])
        for key in fast["roofline"]:
            if key not in ("memory",) and "fraction" not in key:
                assert fast["roofline"][key] == pytest.approx(
                    full["roofline"][key], rel=0.05)
        skip += ("roofline",)
    _same(fast, full, skip=skip)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_hints_cell_equals_the_plain_cell(shape):
    dp = ("data",)
    ov = dryrun._hint_overrides("qwen3-4b", dp, SHAPES[shape][2])
    kw = dict(arch="qwen3-4b", shape=shape, mesh_shape=(2, 1),
              names=("data", "model"), seq=16, batch=4)
    hinted = _cell(**kw, overrides=ov)
    plain = _cell(**kw)
    assert hinted["overrides"] == ov
    _same(hinted, plain, skip=("trace_s", "overrides"))


def test_serving_cells_hold_the_specs_pieces():
    """prefill and decode: the first data rank's model group serves
    ``batch / n_dp`` rows (the whole batch where it does not divide);
    each of its ranks holds the pieces ``param_specs`` gives it (rank 0
    the request's rows besides, and in decode each rank its piece of the
    cache), and the copies between them are the split's collectives and
    the request's scatter."""
    from repro_torch.dist import sharding as tsh
    from repro_torch.models.layers import Unseeded
    from repro_torch.models.transformer import init_params

    mesh = make_fake_mesh((4, 2), ("data", "model"))
    pre = _cell("qwen3-4b", "prefill_32k", (4, 2), ("data", "model"),
                16, 8)
    dec = _cell("qwen3-4b", "decode_32k", (4, 2), ("data", "model"), 16, 6)
    assert pre["cell"]["rows"] == 2 and dec["cell"]["rows"] == 6
    cfg = get_config("qwen3-4b", smoke=True)
    params = init_params(cfg, Unseeded("meta"))
    specs = tsh.param_specs(params, mesh)
    pieces = 0
    for name, p in params.named_parameters():
        split = bool(tsh._path_spec(specs, name))
        pieces += p.numel() * 4 // (2 if split else 1)
    def per_rank(kind, batch):
        c = get_config("qwen3-4b", smoke=True, max_cache=16)
        low = dryrun._trace_cell(c, kind, 16, batch, mesh, ("data",))[0]
        return low.memory_analysis().per_rank["argument"]

    assert list(per_rank("prefill", 8)) == [pieces + 2 * 16 * 4, pieces]
    for rec in (pre, dec):
        assert rec["cell"]["ranks"] == 2 and rec["fits"]
        kinds = set(rec["collectives"]["by_kind"])
        assert {"scatter", "all-reduce", "all-gather"} <= kinds
        assert kinds <= {"scatter", "all-reduce", "all-gather",
                         "all-to-all"}
        assert rec["ici_bytes_per_dev"] > 0 == rec["dci_bytes_per_dev"]
    cache = 2 * cfg.n_layers * 6 * 16 * (cfg.n_kv_heads // 2) \
        * cfg.head_dim * 2  # k and v, bf16, each rank its kv head
    assert per_rank("decode", 6)[1] == pieces + cache


def test_long_context_skips_full_attention():
    rec = dryrun.lower_lm_cell("qwen3-4b", "long_500k", False, smoke=True)
    assert rec["status"] == "skipped(full-attention)"
    rec = dryrun.lower_lm_cell("recurrentgemma-9b", "long_500k", False,
                               smoke=True)
    assert rec["status"] == "ok"


def test_record_has_the_reference_keys():
    rec = _cell("qwen3-4b", "train_4k", (2, 1), ("data", "model"), 16, 4)
    for key in ("status", "arch", "shape", "mesh", "params", "active_params",
                "memory", "flops_per_dev", "hbm_bytes_per_dev",
                "ici_bytes_per_dev", "dci_bytes_per_dev", "collectives",
                "roofline", "cost_source", "trace_s", "fits"):
        assert key in rec, key
    assert {"temp_bytes", "arg_bytes", "out_bytes", "rank0"} <= set(
        rec["memory"])
    kinds = set(rec["collectives"]["by_kind"])
    assert {"scatter", "pmax", "pmean"} <= kinds
    assert "other" not in kinds and "replicate" not in kinds
    assert rec["params"] == get_config("qwen3-4b", smoke=True).param_count()
