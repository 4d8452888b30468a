"""LM serving on the card: the cache invariant of every architecture, the
sliding window past its wrap, and the card against the port's CPU path
on the same weights.

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
from repro_torch.launch import lm_serve
from repro_torch.models.lm import decode_step, prefill
from repro_torch.models.transformer import forward, init_params

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
