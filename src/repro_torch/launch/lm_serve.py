"""Batched LM serving driver: prefill + greedy decode with KV caches.

  PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch qwen3-4b \
      --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu

The reference's ``launch/lm_serve.py`` with ``--device`` (default
``cuda``, which raises without a card; ``cpu`` runs the same code on the
host).  Weights come from ``models.transformer.init_params`` and the
prompts from a ``torch.Generator``, both seeded by ``--seed``: the
reference draws its own with ``jax.random``, so the two CLIs serve
different numbers of the same distributions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.recon import resolve_device
from ..models.lm import decode_step, prefill
from ..models.transformer import init_params

__all__ = ["main", "make_prompts", "serve"]


def make_prompts(cfg, batch: int, prompt_len: int, gen: torch.Generator):
    """Token prompts [B, T] (embeddings [B, T, D] in the activation dtype
    for stub frontends), drawn from ``gen`` on its device."""
    if cfg.embed_inputs:
        return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                             generator=gen, device=gen.device)
    return torch.randn((batch, prompt_len, cfg.d_model), generator=gen,
                       device=gen.device).to(cfg.activation_dtype)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(params, cfg, prompts, n_gen: int, gen: torch.Generator) -> dict:
    """Prefill ``prompts``, then ``n_gen - 1`` greedy decode steps (a stub
    frontend's steps read fresh embeddings from ``gen``).  Returns the
    tokens ``[B, n_gen]`` (int32, on the host), ``prefill_s``,
    ``decode_s`` and ``tok_s`` (decoded tokens per second), on the host
    clock with the device synchronized at both ends."""
    device = prompts.device
    batch, prompt_len = prompts.shape[:2]
    _sync(device)
    t0 = time.perf_counter()
    last_logits, cache = prefill(params, cfg, prompts)
    tok = torch.argmax(last_logits, -1)[:, None].to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    out = [tok]
    pos = prompt_len
    for _ in range(n_gen - 1):
        step_in = tok if cfg.embed_inputs else torch.randn(
            (batch, 1, cfg.d_model), generator=gen, device=device,
        ).to(cfg.activation_dtype)
        tok, cache, _ = decode_step(params, cfg, cache, step_in, pos)
        out.append(tok)
        pos += 1
    _sync(device)
    t2 = time.perf_counter()
    tokens = torch.cat(out, dim=1).cpu().numpy()
    return {"tokens": tokens, "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "tok_s": batch * (n_gen - 1) / max(1e-9, t2 - t1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke,
                     max_cache=args.prompt_len + args.gen)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = init_params(cfg, gen)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, gen)
    out = serve(params, cfg, prompts, args.gen, gen)
    gen_tokens = out["tokens"]
    print(f"prefill {out['prefill_s']:.2f}s, decode {out['decode_s']:.2f}s "
          f"({out['tok_s']:.1f} tok/s), sample row: {gen_tokens[0][:12]}")
    return np.asarray(gen_tokens)


if __name__ == "__main__":
    main()
