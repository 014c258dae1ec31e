"""Serving launcher of the port: batched paged decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
      --arch granite-3-2b --full --batch 4 --prompt-len 128 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch qwen2-moe-a2.7b --batch 2 --prompt-len 8 --new-tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch hymba-1.5b --batch 2 --prompt-len 8 --new-tokens 4

Runs on the card unless ``--device cpu``. ``--full`` serves the
published width (the CUDA kernels take head_dim 64 or 128); without it
the smoke config is served, whose narrow heads only the CPU's plain
path takes. Attention runs the ``flash_pallas`` path (the CUDA kernels
on the card). Weights are random, drawn from a fixed seed. The
whole-batch ``--engine naive`` of the JAX launcher is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import _prefix_len, build_model
from repro_torch.serve.engine import PagedDecodeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--engine", default="paged", choices=["paged"])
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
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)

    engine = PagedDecodeEngine(
        lm=lm, params=params, max_batch=B,
        max_seq_len=_prefix_len(cfg) + S + args.new_tokens + 16,
        max_new=args.new_tokens,
        page_size=args.page_size, prefill_chunk=max(S, 8),
        temperature=args.temperature, device=dev)
    t0 = time.perf_counter()
    out = engine.generate({"tokens": tokens}, args.new_tokens)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[serve:paged] {args.arch} on {dev}: generated {tuple(out.shape)} "
          f"in {dt:.2f}s ({args.new_tokens * B / dt:.1f} tok/s)")
    print(out[0].tolist()[:8])


if __name__ == "__main__":
    main()
