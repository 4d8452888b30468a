"""LM serving and training on the card: the cache invariant of every
architecture, the sliding window past its wrap, the card against the
port's CPU path on the same weights (a prefill; a train step), the
hierarchical gradient sync on a mesh of one card, and the training CLI.

Every test here carries the ``gpu`` marker and skips where no CUDA
device is present.  The file imports no JAX, so it runs on the GPU
machine as it is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_gpu.py
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import lm_serve
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.lm import decode_step, prefill
from repro_torch.models.transformer import forward, init_params
from repro_torch.opt import AdamW, leaves

B, T = 2, 24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the GPU machine")
    return torch.device("cuda")


def _invariant(params, cfg, x, t):
    pos = torch.arange(t + 1, device=x.device).expand(x.shape[0], t + 1)
    ref, _, _ = forward(params, cfg, x, positions=pos)
    _, cache = prefill(params, cfg, x[:, :t])
    _, _, dec = decode_step(params, cfg, cache, x[:, t:t + 1], t)
    return dec.cpu().numpy(), ref[:, t].cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cuda_decode_matches_forward(cuda, name):
    """Prefill T tokens and decode token T on the card against the
    forward over T+1 tokens (bf16, the reference's bound 2e-2)."""
    cfg = get_config(name, smoke=True, max_cache=T + 8,
                     moe_capacity_factor=8.0)
    gen = torch.Generator(cuda).manual_seed(0)
    params = init_params(cfg, gen)
    assert all(p.device.type == "cuda" for p in params.parameters())
    x = lm_serve.make_prompts(cfg, B, T + 1, gen)
    dec, ref = _invariant(params, cfg, x, T)
    np.testing.assert_allclose(dec, ref, rtol=2e-2, atol=2e-2)
    if name == "recurrentgemma-9b":
        t_long = cfg.window + 9
        x = lm_serve.make_prompts(cfg, B, t_long + 1, gen)
        dec, ref = _invariant(params, cfg, x, t_long)
        np.testing.assert_allclose(dec, ref, rtol=3e-2, atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen3-4b", "grok-1-314b", "xlstm-350m"])
def test_cuda_matches_the_cpu_path(cuda, name):
    """The same weights on the card and on the host: f32 prefill logits
    within 1e-4 of max|.| and the same greedy tokens; bf16 prefill
    logits within 2e-2."""
    cfg = get_config(name, smoke=True, max_cache=T + 8,
                     moe_capacity_factor=8.0)
    gen = torch.Generator(cuda).manual_seed(2)
    params = init_params(cfg, gen)
    host = copy.deepcopy(params).to("cpu")
    x = lm_serve.make_prompts(cfg, B, T, gen)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        c = dataclasses.replace(cfg, activation_dtype=dtype,
                                cache_dtype=dtype)
        got, cache = prefill(params, c, x)
        want, host_cache = prefill(host, c, x.cpu())
        err = (got.cpu() - want).abs().max() / want.abs().max()
        assert err <= tol, (dtype, float(err))
        if dtype == torch.float32:
            tok = torch.argmax(got, -1)[:, None].to(torch.int32)
            host_tok = torch.argmax(want, -1)[:, None].to(torch.int32)
            assert torch.equal(tok.cpu(), host_tok)
            for i in range(4):
                tok, cache, _ = decode_step(params, c, cache, tok, T + i)
                host_tok, host_cache, _ = decode_step(host, c, host_cache,
                                                      host_tok, T + i)
                assert torch.equal(tok.cpu(), host_tok), i


@pytest.mark.gpu
def test_cuda_cli_serves(cuda, capsys):
    gen = lm_serve.main(["--arch", "qwen3-4b", "--smoke", "--batch", "2",
                         "--prompt-len", "8", "--gen", "4"])
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["smollm-135m", "moonshot-v1-16b-a3b",
                                  "recurrentgemma-9b", "xlstm-350m"])
def test_cuda_train_step_matches_the_cpu_path(cuda, name):
    """One train step's loss and gradients on the card against the host,
    the same weights and batch: f32 activations, the loss within 1e-4
    (relative) and every gradient leaf within 1e-3 of its max|.|; bf16,
    the loss within 2e-2."""
    cfg = get_config(name, smoke=True, moe_capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(3))
    host = copy.deepcopy(params).to("cpu")
    rng = np.random.default_rng(3)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(
        np.int32)}
    batch["inputs"] = (batch["labels"] if cfg.embed_inputs else
                       rng.standard_normal((B, T, cfg.d_model)).astype(
                           np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, activation_dtype=dtype)
        lc, _, gc = lm._value_and_grad(params, c, batch)
        lh, _, gh = lm._value_and_grad(host, c, batch)
        assert all(g.device.type == "cuda" for g in gc)
        rel = abs(float(lc) - float(lh)) / abs(float(lh))
        if dtype == torch.float32:
            assert rel <= 1e-4, rel
            for a, b in zip(gc, gh):
                assert float((a.cpu() - b).abs().max()) <= 1e-3 * float(
                    b.abs().max())
        else:
            assert rel <= 2e-2, rel


@pytest.mark.gpu
def test_cuda_hier_step_on_one_card(cuda):
    """``make_hier_train_step`` on a (pod=2, data=2, model=1) mesh whose
    four ranks share the card, against the spmd step on the same global
    batch (f32 activations): loss 1e-4, each synced gradient leaf within
    2**-7 of its max|g|, parameters 5e-3."""
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              activation_dtype=torch.float32)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(4))
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"),
                     devices=[cuda] * 4)
    batch = TokenStream(cfg.vocab_size, 32, 8, seed=4).batch(0)
    opt = AdamW(lr=1e-3, grad_clip=0.0)
    hier = lm.make_hier_train_step(cfg, opt, mesh)
    _, _, g1 = lm._value_and_grad(params, cfg, batch)
    _, _, g2 = hier.sync(params, batch)
    for a, b in zip(g2, g1):
        assert a.device.type == "cuda"
        assert float((a - b).abs().max()) <= 2 ** -7 * float(b.abs().max())
    p1, _, m1 = lm.make_train_step(cfg, opt)(params, opt.init(params), batch)
    p2, _, m2 = hier(params, opt.init(params), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p1), leaves(p2))) < 5e-3


@pytest.mark.gpu
def test_cuda_cli_trains(cuda, capsys):
    """``python -m repro_torch.launch.train --steps 3`` on the card."""
    losses = train_cli.main(["--arch", "smollm-135m", "--smoke", "--steps",
                             "3", "--batch", "4", "--seq", "32",
                             "--log-every", "1"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "final loss" in out and "step     2" in out


@pytest.mark.gpu
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cuda_remat_gives_the_bits_of_none(cuda, name):
    """``remat="full"`` and ``"dots"`` on the card: the loss and every
    gradient leaf of ``"none"``, bit for bit (SMOKE widths, bf16)."""
    cfg = get_config(name, smoke=True, moe_capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0))
    batch = TokenStream(cfg.vocab_size, T, B, seed=0).batch(0) \
        if cfg.embed_inputs else {
            "inputs": np.random.default_rng(0).standard_normal(
                (B, T, cfg.d_model)).astype(np.float32),
            "labels": np.random.default_rng(1).integers(
                0, cfg.vocab_size, (B, T)).astype(np.int32)}
    got = {m: lm._value_and_grad(params, dataclasses.replace(cfg, remat=m),
                                 batch) for m in ("none", "full", "dots")}
    for m in ("full", "dots"):
        assert torch.equal(got[m][0], got["none"][0]), m
        for a, b in zip(got[m][2], got["none"][2]):
            assert torch.equal(a, b), m


@pytest.mark.gpu
def test_cuda_dot_is_the_plain_product(cuda):
    """``layers.dot`` keeps cuBLAS's product on the card (its CPU rule is
    for the host's GEMMs)."""
    from repro_torch.models.layers import dot

    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((132, 256), generator=gen, device=cuda).bfloat16()
    w = torch.randn((256, 512), generator=gen, device=cuda)
    assert torch.equal(dot(x, w), x @ w.bfloat16())
