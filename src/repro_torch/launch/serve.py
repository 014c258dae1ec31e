"""Serving launcher of the port: batched decode through either engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
      --arch granite-3-2b --full --batch 4 --prompt-len 128 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch qwen2-moe-a2.7b --batch 2 --prompt-len 8 --new-tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch musicgen-medium --engine naive
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch internvl2-1b

Runs on the card unless ``--device cpu``. ``--full`` serves the
published width (the CUDA kernels take any head_dim up to 192: 64, 128
and 192 are instances, any other runs zero-padded to the next); without
it the smoke config is served. Attention runs the ``flash_pallas`` path
(the CUDA kernels on the card). Weights are random, drawn from a fixed
seed; so are the prompts: (B, S, CB) token streams for audio, and f32
``vis_embeds`` (B, n_vis, d_vis) for the VLM. ``--engine paged`` (the
default here; the JAX launcher defaults to ``naive``) is the
continuous-batching engine, ``--engine naive`` the whole-batch
``DecodeEngine``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import _prefix_len, build_model
from repro_torch.serve.engine import DecodeEngine, PagedDecodeEngine


def make_batch(cfg, batch: int, prompt_len: int, seed: int = 1) -> dict:
    """Random prompts from a numpy seed: tokens (B, S), or (B, S, CB) for
    audio, and f32 ``vis_embeds`` (B, n_vis, d_vis) for the VLM."""
    rs = np.random.RandomState(seed)
    cb = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    out = {"tokens": rs.randint(0, cfg.vocab_size,
                                size=(batch, prompt_len) + cb).astype(
                                    np.int32)}
    if cfg.family == "vlm":
        out["vis_embeds"] = rs.randn(batch, cfg.n_vis_tokens,
                                     cfg.d_vis).astype(np.float32)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--engine", default="paged", choices=["paged", "naive"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="serve the published config instead of the smoke one")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    cfg = cfg.with_(attn_impl="flash_pallas")
    lm = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(gen, device=dev)
    B, S = args.batch, args.prompt_len
    batch = make_batch(cfg, B, S)

    t0 = time.perf_counter()
    if args.engine == "paged":
        engine = PagedDecodeEngine(
            lm=lm, params=params, max_batch=B,
            max_seq_len=_prefix_len(cfg) + S + args.new_tokens + 16,
            max_new=args.new_tokens,
            page_size=args.page_size, prefill_chunk=max(S, 8),
            temperature=args.temperature, device=dev)
        out = engine.generate(batch, args.new_tokens)
    else:
        engine = DecodeEngine(lm, params, max_seq_len=S + args.new_tokens,
                              device=dev)
        out = engine.generate(batch, args.new_tokens,
                              temperature=args.temperature)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[serve:{args.engine}] {args.arch} on {dev}: generated "
          f"{tuple(out.shape)} in {dt:.2f}s ({args.new_tokens * B / dt:.1f} "
          f"tok/s)")
    print(out[0].tolist()[:8])


if __name__ == "__main__":
    main()
