"""Training launcher of the port: HWA and every paper baseline on the
smoke config of an architecture, with preemption-safe checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 8 --k 2 --window 3 --sync-period 2 \
      --checkpoint-dir ckpt --checkpoint-every 4 --keep 2 [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --method sam --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 8 --k 2 --window 3 --sync-period 2 --resilient \
      [--max-param-rms 10]

Runs on the card unless ``--device cpu``. Mirrors the JAX package's
single-device launcher (``repro.launch.train``), whose checkpoint
directories it reads and writes. ``--resilient`` and ``--max-param-rms``
select the alive-masked sync (``HWAConfig.resilient``). Its mesh-native
flags (``--wa-dtype`` and ``--comms-dtype`` among them: there they
compress the mesh-native window state), the sync-tree flags and
``--inject-nan`` (offered there only with ``--mesh-native``) wait for
the multi-replica sync across processes (ROADMAP.md Queue A 13). A
caller that builds its own ``TrainConfig`` passes any ``HWAConfig``
window (stride, streaming, kernels) through the Trainer unchanged. The
vlm and audio archs are refused, as the JAX launcher refuses them: their
batches carry vision embeddings or codebook streams, which the Trainer's
(tokens, targets) pipeline does not; ``core.hwa``'s functions take them.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.hwa import HWAConfig
from repro_torch.data import DataPipeline, make_markov_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import METHODS, PARALLEL, TrainConfig, \
    Trainer, lm_task


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--method", default="hwa", choices=list(METHODS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--k", type=int, default=2, help="HWA replicas K")
    ap.add_argument("--sync-period", type=int, default=0, help="H (0=epoch)")
    ap.add_argument("--window", type=int, default=10, help="I")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-impl", default="",
                    choices=["", "naive", "flash_pallas"],
                    help="override the arch's attention implementation; "
                         "flash_pallas selects the flash kernels (their "
                         "plain versions on the CPU)")
    ap.add_argument("--resilient", action="store_true",
                    help="alive-masked sync: a replica whose weights go "
                         "non-finite (or whose RMS exceeds "
                         "--max-param-rms) is excluded from the K-mean "
                         "and re-seeded from W̄ at the next sync")
    ap.add_argument("--max-param-rms", type=float, default=0.0,
                    help="resilient only: divergence threshold on a "
                         "replica's parameter RMS (0 = finiteness only)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="preemption-safe checkpoint session directory "
                         "(manifest-last + CRC-verified)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="steps between checkpoints (0 = off)")
    ap.add_argument("--keep", type=int, default=3,
                    help="checkpoints retained (older ones are removed)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest INTACT checkpoint in "
                         "--checkpoint-dir (bit-exact: torn or corrupted "
                         "saves are skipped)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    if args.attn_impl:
        cfg = cfg.with_(attn_impl=args.attn_impl)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit(f"{args.arch}: the Trainer's batches are (tokens, "
                         f"targets) only; train the modality archs through "
                         f"lm.loss and core.hwa directly")
    lm = build_model(cfg)
    ds = make_markov_lm_dataset(vocab=cfg.vocab_size, seq_len=args.seq_len,
                                n_train=2048, n_test=512, seed=args.seed,
                                device=dev)
    K = args.k if args.method in PARALLEL else 1
    pipe = DataPipeline(ds, batch_size=args.batch_size, n_replicas=K,
                        seed=args.seed)
    tc = TrainConfig(
        method=args.method, total_steps=args.steps,
        batch_size=args.batch_size, base_lr=args.lr, seed=args.seed,
        hwa=HWAConfig(n_replicas=K, sync_period=args.sync_period,
                      window=args.window, resilient=args.resilient,
                      max_param_rms=args.max_param_rms or None),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        checkpoint_keep=args.keep, resume=args.resume)
    out = Trainer(lm_task(lm, pipe, seed=args.seed), tc).run(log=True)
    print(f"[train] {args.arch}/{args.method} on {dev}: final "
          f"{out['final']}, best {out['best']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"final": out["final"], "best": out["best"],
                       "history": out["history"]}, f, indent=2)


if __name__ == "__main__":
    main()
