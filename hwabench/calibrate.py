"""The readings each limit of ``limits/<workload>.json`` is set from, in
one process on the card:

    python3 hwabench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out FILE]

For each seed: the program's numbers, from the cell's set-up steps,
against the reference's. For each control seed also the control's, the
reference in float8 in the program's place, and the planted fault's:
the reference with half of each replica's rows left out (the mean over
the rest). A state left unchanged reads 1 by the numbers' measure and
needs no run. One JSON line a reading goes to ``--out``.
"""
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != HERE]


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    import argparse

    import torch

    from hwabench.harness import Bench, build_cell
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--out", default=os.path.join(HERE, ".cache",
                                                   "calibrate.jsonl"))
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    bench = Bench(ROOT)
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(device)

    def emit(seed, side, nums, **extra):
        row = {"workload": args.workload, "seed": seed, "side": side,
               "numbers": nums, "card": card, **extra}
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        driver, cell = build_cell(bench, args.workload, seed, device)
        cell.setup(lambda what: None)
        cell.free()
        ref = cell.reference_readings()
        emit(seed, "program", driver.numbers(cell.program_readings, ref),
             seconds=time.perf_counter() - t0)
        if seed in args.control_seeds:
            emit(seed, "control", driver.numbers(
                cell.reference_readings(quant=True), ref))
            emit(seed, "fault_half_batch", driver.numbers(
                cell.reference_readings(half_batch=True), ref))
        del cell, driver
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
