"""A cell run on the CPU at a smoke size: the harness's own rehearsal.

    PYTHONPATH=src:. python3 -m hwabench.rehearse \
        --workload train.granite-3-2b-l18.h2 [--seed 5] [--seconds 2]

Every width of the cell's configuration and every size of its traffic
is cut to ``SMOKE``'s (the program runs its plain kernels on the CPU);
the set-up, the window, the readers and the comparison with the
reference are the card's. Prints the result's dict; its numbers are CPU
numbers and are never reported as the card's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from hwabench.harness import Bench, run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the smoke sizes: configuration keys, then each traffic kind's
SMOKE = {
    "config": {"hidden_size": 64, "num_attention_heads": 4,
               "num_key_value_heads": 2, "num_hidden_layers": 2,
               "vocab_size": 256},
    "dense": {"intermediate_size": 128},
    "moe": {"intermediate_size": 32, "num_local_experts": 4,
            "num_experts_per_tok": 2},
    "train": {"batch": 2, "seq": 64},
}

#: smoke limits by configuration family, from the CPU's readings at the
#: smoke sizes (program against control, seeds 5, 7 and 11): above what
#: the program's plain kernels give, below what the control gives (the
#: card's limits are ``limits/<workload>.json``)
SMOKE_LIMITS = {
    "dense": {"loss_gap": 0.006, "grad_gap": 0.01, "change_gap": 0.01,
              "wa_gap": 0.01},
    "moe": {"loss_gap": 0.055, "grad_gap": 0.08, "change_gap": 0.06,
            "wa_gap": 0.02},
}


def smoke_limits(bench, workload: str) -> dict:
    moe = "num_local_experts" in bench.config(bench.workload(workload)
                                              ["config"])
    return dict(SMOKE_LIMITS["moe" if moe else "dense"])


class SmokeBench(Bench):
    """The manifest's cells with every configuration and traffic file
    cut to the smoke sizes."""

    def config(self, name):
        cfg = dict(super().config(name), **SMOKE["config"])
        moe = "num_local_experts" in cfg
        return dict(cfg, **SMOKE["moe" if moe else "dense"])

    def traffic(self, name):
        tr = super().traffic(name)
        return dict(tr, **SMOKE[tr["kind"]])

    def limits(self, workload):
        return smoke_limits(self, workload)


def rehearse(workload: str, seed: int = 5, seconds: float = 2.0,
             root: str = ROOT, trace: bool = False, **hooks) -> dict:
    """:func:`harness.run` on the CPU at the smoke sizes; ``trace`` reads
    the per-layer metrics (those that need a device trace find none)."""
    import torch
    torch.manual_seed(0)
    return run(SmokeBench(root), workload, seed, seconds, trace, "cpu",
               time.perf_counter(), log=lambda *a, **k: None, **hooks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    print(json.dumps(rehearse(args.workload, args.seed, args.seconds),
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
