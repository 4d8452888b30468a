"""LM serving on the PyTorch port (``models/lm.py``, ``launch/lm_serve.py``)
against the JAX package on the CPU: prefill and one decode step for
every architecture at f32 and bf16, greedy tokens over a prefill and 8
decode steps in f32, the sliding-window ring past its wrap, the port's
own cache invariant, and the CLI's shapes and loop.  Weights come
through ``params_from_reference``, inputs from numpy with a seed; the
tolerances and the bf16 MoE near-tie rule are ``test_torch_lm_models``'s.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import lm_serve
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as tt
from test_torch_lm_models import (
    B, DTYPES, MAX_TIED, T, TOL, first_near_tie, inputs, positions, ref_model,
)

GREEDY_STEPS = 8


@functools.lru_cache(maxsize=None)
def _ref_fns(name, dtype):
    """The reference's jitted prefill and decode step (one compile each,
    shared by the tests of an architecture and dtype)."""
    jc = ref_model(name, dtype)[0]
    return (jax.jit(lambda p, x: jlm.prefill(p, jc, x)),
            jax.jit(lambda p, c, t, q: jlm.decode_step(p, jc, c, t, q)))


def _last_rows(name, dtype, tp, tc, x):
    """Rows whose last token compares: every row, but in bf16 MoE archs
    not one with a router near tie up to that token."""
    keep = first_near_tie(tp, tc, x, dtype) >= x.shape[1]
    assert keep.mean() >= 1 - MAX_TIED, (name, keep)
    return keep


def _err(got, want, rows):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want)[rows].max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_match_reference(name, dtype):
    """Last-token logits of a T-token prefill, then one decode step at
    position T: logits, next token and the caches' write positions."""
    jc, tc, jp, tp = ref_model(name, dtype)
    pf, dc = _ref_fns(name, dtype)
    x = inputs(jc, T + 1)
    jl_, jcache = pf(jp, x[:, :T])
    tl_, tcache = tlm.prefill(tp, tc, torch.from_numpy(x[:, :T]))
    rows = _last_rows(name, dtype, tp, tc, x)
    assert _err(tl_, jl_, rows) <= TOL[dtype]
    jtok, jcache, jd = dc(jp, jcache, x[:, T:], jnp.int32(T))
    ttok, tcache, td = tlm.decode_step(tp, tc, tcache,
                                       torch.from_numpy(x[:, T:]), T)
    assert ttok.dtype == torch.int32 and tuple(ttok.shape) == (B, 1)
    assert _err(td, jd, rows) <= TOL[dtype]
    if dtype == "f32":
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for kind, c in zip(tc.pattern_kinds, tcache):
        if kind in ("attn", "local"):
            assert c["pos"] == T + 1


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_greedy_tokens_match_reference(name):
    """f32: the prefill's argmax and 8 greedy decode steps give the
    reference's tokens (a stub frontend's steps read the same numpy
    embeddings on both sides)."""
    jc, tc, jp, tp = ref_model(name, "f32")
    pf, dc = _ref_fns(name, "f32")
    x = inputs(jc, T)
    jl_, jcache = pf(jp, x)
    tl_, tcache = tlm.prefill(tp, tc, torch.from_numpy(x))
    jtok = np.asarray(jnp.argmax(jl_, -1)[:, None].astype(jnp.int32))
    ttok = torch.argmax(tl_, -1)[:, None].to(torch.int32)
    got, want = [ttok.numpy()], [jtok]
    steps = inputs(jc, GREEDY_STEPS, seed=1)
    for i in range(GREEDY_STEPS):
        if jc.embed_inputs:
            j_in, t_in = jtok, ttok
        else:
            j_in = steps[:, i:i + 1]
            t_in = torch.from_numpy(j_in)
        jtok, jcache, _ = dc(jp, jcache, j_in, jnp.int32(T + i))
        jtok = np.asarray(jtok)
        ttok, tcache, _ = tlm.decode_step(tp, tc, tcache, t_in, T + i)
        got.append(ttok.numpy())
        want.append(jtok)
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sliding_window_wrap_matches_reference(dtype):
    """recurrentgemma's local attention past its window (``window + 9``
    tokens): the ring's prefill roll and the decode step's unwrap give
    the reference's logits, and the port's decode equals its own forward
    that sees the window only (the reference's bound, 3e-2)."""
    name = "recurrentgemma-9b"
    jc, tc, jp, tp = ref_model(name, dtype, max_cache=64)
    t_long = tc.window + 9
    x = inputs(jc, t_long + 1)
    jl_, jcache = jax.jit(lambda p, x: jlm.prefill(p, jc, x))(
        jp, x[:, :t_long])
    tl_, tcache = tlm.prefill(tp, tc, torch.from_numpy(x[:, :t_long]))
    assert _err(tl_, jl_, slice(None)) <= TOL[dtype]
    _, _, jd = jax.jit(lambda p, c, t, q: jlm.decode_step(p, jc, c, t, q))(
        jp, jcache, x[:, t_long:], jnp.int32(t_long))
    _, _, td = tlm.decode_step(tp, tc, tcache,
                               torch.from_numpy(x[:, t_long:]), t_long)
    assert _err(td, jd, slice(None)) <= TOL[dtype]
    full, _, _ = tt.forward(tp, tc, torch.from_numpy(x),
                            positions=torch.from_numpy(positions(t_long + 1)))
    np.testing.assert_allclose(td.numpy(), full[:, t_long].numpy(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_matches_forward_on_the_port(name):
    """The cache invariant every serving path depends on, on the port's
    own weights (``init_params`` from a generator): prefill T tokens,
    decode token T, against the forward over T+1 tokens (bf16, the
    reference's bound ``rtol = atol = 2e-2``)."""
    cfg = get_config(name, smoke=True, max_cache=T + 8,
                     moe_capacity_factor=8.0)
    params = tt.init_params(cfg, torch.Generator().manual_seed(1))
    x = torch.from_numpy(inputs(cfg, T + 1, seed=2))
    ref, _, _ = tt.forward(params, cfg, x,
                           positions=torch.from_numpy(positions(T + 1)))
    _, cache = tlm.prefill(params, cfg, x[:, :T])
    _, _, dec = tlm.decode_step(params, cfg, cache, x[:, T:], T)
    np.testing.assert_allclose(dec.numpy(), ref[:, T].numpy(), rtol=2e-2,
                               atol=2e-2)


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen3-4b", "musicgen-large"])
def test_cli_serves_on_cpu(arch, capsys):
    """``--device cpu``: a [batch, gen] int32 token array in the
    vocabulary, the reference's report line, and the same tokens from
    the same seed."""
    argv = ["--arch", arch, "--smoke", "--batch", "3", "--prompt-len",
            "8", "--gen", "5", "--device", "cpu"]
    gen = lm_serve.main(argv)
    cfg = get_config(arch, smoke=True)
    assert gen.shape == (3, 5) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all()
    out = capsys.readouterr().out
    assert out.startswith("prefill ") and "tok/s), sample row:" in out
    np.testing.assert_array_equal(lm_serve.main(argv), gen)
    assert not np.array_equal(lm_serve.main(argv + ["--seed", "1"]), gen)


def test_cli_serve_loop_decodes_with_the_cache():
    """``serve``'s tokens are the prefill's argmax, then each step's
    argmax of ``decode_step`` fed the previous token."""
    cfg = get_config("smollm-135m", smoke=True, max_cache=16)
    gen = torch.Generator().manual_seed(3)
    params = tt.init_params(cfg, gen)
    prompts = lm_serve.make_prompts(cfg, 2, 6, gen)
    out = lm_serve.serve(params, cfg, prompts, 4, gen)
    assert out["tokens"].shape == (2, 4) and out["tok_s"] > 0
    logits, cache = tlm.prefill(params, cfg, prompts)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    want = [tok]
    for i in range(3):
        tok, cache, _ = tlm.decode_step(params, cfg, cache, tok, 6 + i)
        want.append(tok)
    np.testing.assert_array_equal(out["tokens"], torch.cat(want, 1).numpy())


def test_cli_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_serve.main(["--arch", "smollm-135m", "--smoke"])


def test_serve_alias_is_deprecated():
    import importlib
    import sys

    sys.modules.pop("repro_torch.launch.serve", None)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        mod = importlib.import_module("repro_torch.launch.serve")
    assert mod.main is lm_serve.main
    assert any(issubclass(w.category, DeprecationWarning) for w in seen)
