"""fault-check: deterministic fault-injection harness over the resilience
stack (counterpart of ``repro.resilience.check``, all eight legs).

    PYTHONPATH=src python -m repro_torch.resilience.check [--smoke] \
        [--device cpu] [--only SUBSTR] [--json PATH] [--list]

Every leg is a deterministic scenario with a hard pass/fail verdict:

  masked-parity    the all-healthy alive-masked mean is BITWISE equal to
                   the plain K-mean (tree level and packed-buffer level)
  nan-replica      a NaN-poisoned replica is quarantined at sync; the
                   run reaches the final step with finite W̿
  resume-exact     checkpoint at N/2, rerun with --resume: final state
                   bit-equal to the uninterrupted run
  kill-mid-save    a simulated preemption truncating the manifest
                   mid-write leaves a torn, skipped checkpoint; the
                   session falls back to the previous intact one
  corrupt-fallback bit-flip the newest checkpoint: CRC verification
                   rejects it and --resume recomputes from the previous
                   intact save, bit-exactly matching the clean run
  transient-io     injected OSErrors during a save are retried with
                   capped backoff; exhaustion surfaces the error
  store-partial    a truncated outer_*.npz is skipped (with a warning) by
                   the window average; retention keeps the last N
  session-gc       the checkpoint session retains ``keep`` newest steps
                   and the newest survivor always verifies

The three mesh legs (``nan-replica``, ``resume-exact`` and
``corrupt-fallback``) drive the mesh-native launcher
(``launch.train.run_mesh_native``: two spawned ranks) with the
reference's ``_mesh_args`` defaults, the smoke granite-3-2b; a caller
passes ``run`` (launcher flags and a model config) to run them at
another size, as ``chip_smoke.py`` does at the published width. Runs are
compared by the SHA-256 of their final replicas, W̿, ring and total.
``REPRO_FAULT_SMOKE=1`` (or ``--smoke``) runs the smoke subset. The
legs' tensors live on ``--device`` (the card unless ``cpu``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.common.pytree import sum_axis0_f32, tree_leaves, \
    tree_mean_axis0
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import online_mean_ref
from repro_torch.resilience.faults import (InjectedIOError, KillAt,
                                           SimulatedCrash, TransientIO,
                                           truncate_file)
from repro_torch.resilience.health import masked_mean_axis0, \
    renormalized_inv
from repro_torch.resilience.session import CheckpointSession

#: env var selecting the smoke subset
SMOKE_ENV = "REPRO_FAULT_SMOKE"


@dataclasses.dataclass
class Leg:
    """One deterministic fault scenario: ``run(device)`` returns a detail
    line and raises on failure."""
    name: str
    run: Callable[[torch.device], str]
    smoke: bool = False


# ------------------------------------------------------------- helpers


def _trees_equal(a, b) -> bool:
    """Same leaves to the bit (dtype, shape, bytes)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if not torch.equal(x.cpu().reshape(-1).view(torch.uint8),
                           y.cpu().reshape(-1).view(torch.uint8)):
            return False
    return True


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _demo_tree(seed: int, device):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((5, 7))
                                  .astype(np.float32)).to(device),
            "b": torch.from_numpy(rng.standard_normal((11,))
                                  .astype(np.float32)).to(device)}


def _mesh_args(device, **kw):
    """Launcher arguments for ``run_mesh_native``: the reference's
    defaults (tiny smoke config, K 2, H 2, I 3, 8 steps) on ``device``."""
    from repro_torch.launch.train import mesh_args
    base = dict(arch="granite-3-2b", k=2, tp=1, fsdp=False, sync_tree="flat",
                pods=0, outer_every=2, window=3, seq_len=16, batch_size=4,
                lr=0.3, seed=0, steps=8, sync_period=2, attn_impl="",
                resilient=False, max_param_rms=0.0, inject_nan="",
                wa_dtype="f32", comms_dtype="f32", checkpoint_dir="",
                checkpoint_every=0, keep=3, resume=False,
                device=str(device))
    base.update(kw)
    return mesh_args(**base)


def _mesh_run(device, run, **kw):
    """``run_mesh_native`` over ``_mesh_args(device, **kw)`` with ``run``
    on top (launcher flags, and ``cfg``: the model config), returning
    rank 0's result with the final state's digest."""
    from repro_torch.launch.train import run_mesh_native
    run = dict(run or {})
    cfg = run.pop("cfg", None)
    return run_mesh_native(_mesh_args(device, **dict(kw, **run)), cfg=cfg,
                           with_state=False, digest=True)


def _memory(out) -> str:
    """A run's device memory per rank on the card (GiB): after a resume's
    load, and at the peak; empty on the CPU."""
    ranks = out["ranks"]
    if ranks[0]["peak_gib"] is None:
        return ""
    text = "; device memory per rank"
    if ranks[0]["resume_gib"] is not None:
        text += (f" after the resume's load "
                 f"{[round(r['resume_gib'], 2) for r in ranks]} GiB,")
    return text + f" peak {[round(r['peak_gib'], 2) for r in ranks]} GiB"


# ---------------------------------------------------------------- legs


def leg_masked_parity(device) -> str:
    rng = np.random.default_rng(0)
    K = 4

    def put(a):
        return torch.from_numpy(a).to(device)

    tree = {
        "w": put(rng.standard_normal((K, 3, 5)).astype(np.float32)),
        "b": put(rng.standard_normal((K, 7)).astype(np.float32)),
        # an integer leaf (adamw's step count): its mean is f32
        "count": torch.arange(K, dtype=torch.int32, device=device),
    }
    all_alive = torch.ones((K,), dtype=torch.bool, device=device)
    _check(_trees_equal(masked_mean_axis0(tree, all_alive),
                        tree_mean_axis0(tree)),
           "all-alive masked_mean_axis0 != tree_mean_axis0 (tree level)")

    # one dead replica: finite and ≈ the mean of the survivors
    dead = 2
    poisoned = dict(tree)
    poisoned["w"] = tree["w"].clone()
    poisoned["w"][dead] = float("nan")
    alive = all_alive.clone()
    alive[dead] = False
    got = masked_mean_axis0(poisoned, alive)
    _check(bool(torch.isfinite(got["w"]).all()),
           "masked mean leaked the NaN replica")
    keep = [i for i in range(K) if i != dead]
    ref = tree["w"].cpu().double()[keep].mean(0)
    _check(float((got["w"].cpu().double() - ref).abs().max()) < 1e-6,
           "masked mean deviates from the survivors' mean")

    # packed-buffer level: the pinned multiplier over a masked sum
    inv_pin = renormalized_inv(torch.tensor(float(K), device=device), K)
    _check(inv_pin.cpu().numpy().tobytes()
           == np.float32(1.0 / K).tobytes(),
           "renormalized_inv does not pin the f32 1/K")
    sbuf = put(rng.standard_normal((K, 257)).astype(np.float32))
    plain = online_mean_ref(sbuf)
    masked = sum_axis0_f32(torch.where(all_alive[:, None], sbuf,
                                       torch.zeros((), device=device))
                           ) * inv_pin
    _check(_trees_equal(plain, masked),
           "all-alive packed masked mean != plain packed mean")
    return "all-alive masked mean bitwise == plain mean (tree + packed)"


def leg_nan_replica(device, run=None) -> str:
    out = _mesh_run(device, run, steps=8, resilient=True, inject_nan="2:1")
    _check(out["wa_finite"], "W̿ went non-finite despite the alive mask")
    _check(out["k_alive_min"] == 1,
           f"expected the poisoned sync to see k_alive=1, got "
           f"{out['k_alive_min']}")
    final = [h for h in out["history"] if h.get("sync") == "outer"][-1]
    _check(final["k_alive"] == 2,
           f"re-seeded replica did not recover (final k_alive "
           f"{final['k_alive']})")
    return (f"poisoned replica quarantined (k_alive dipped to "
            f"{out['k_alive_min']}, recovered to {final['k_alive']}), "
            f"W̿ finite at step {out['history'][-1]['step']}"
            + _memory(out))


def leg_resume_exact(device, run=None) -> str:
    clean = _mesh_run(device, run, steps=8)
    with tempfile.TemporaryDirectory() as d:
        _mesh_run(device, run, steps=4, checkpoint_dir=d, checkpoint_every=4)
        resumed = _mesh_run(device, run, steps=8, checkpoint_dir=d,
                            checkpoint_every=4, resume=True)
    _check(resumed["resumed_from"] == 4,
           f"resumed from {resumed['resumed_from']}, not step 4")
    _check(clean["digest"] == resumed["digest"],
           "resumed final state differs from the uninterrupted run")
    return ("checkpoint@4 + --resume reproduces the 8-step run bit-exactly"
            + _memory(resumed))


def leg_kill_mid_save(device) -> str:
    t4, t8 = _demo_tree(4, device), _demo_tree(8, device)
    with tempfile.TemporaryDirectory() as d:
        crash = CheckpointSession(
            d, fault_injector=KillAt("manifest_write", occurrence=2,
                                     truncate_frac=0.4))
        crash.save(4, {"state": t4})
        died = False
        try:
            crash.save(8, {"state": t8})
        except SimulatedCrash:
            died = True
        _check(died, "KillAt did not fire on the second manifest write")

        fresh = CheckpointSession(d)
        ok8, _ = fresh.verify(8)
        _check(not ok8, "torn step-8 checkpoint verifies")
        _check(fresh.latest_intact() == 4,
               f"latest_intact {fresh.latest_intact()} != 4")
        _check(_trees_equal(fresh.load(4, "state", t4), t4),
               "fallback checkpoint does not round-trip")
        fresh.save(8, {"state": t8})      # post-crash rewrite heals it
        _check(fresh.latest_intact() == 8, "healed step 8 not intact")
    return ("preemption mid-manifest leaves a torn dir; session falls "
            "back to step 4 and heals on the next save")


def leg_corrupt_fallback(device, run=None, saved=None) -> str:
    """``saved`` = (an 8-step run's result, the session it checkpointed
    into every 4 steps) stands for the clean and the saving run: that run
    is uninterrupted, and its saves are this leg's (each returned from a
    complete save, so step 8 is not checked again before the flip). The
    resumed run saves nothing. The ranks' own scan must reject the
    flipped step 8."""
    from repro_torch.resilience.faults import flip_bit

    with tempfile.TemporaryDirectory() as d:
        if saved is None:
            clean = _mesh_run(device, run, steps=8)
            _mesh_run(device, run, steps=8, checkpoint_dir=d,
                      checkpoint_every=4)
            _check(CheckpointSession(d).verify(8)[0],
                   "expected intact step 8")
        else:
            clean, d = saved
        sess = CheckpointSession(d)
        _check(sess.steps() == [4, 8], f"checkpoints at {sess.steps()}")
        flip_bit(os.path.join(sess.step_dir(8), "inner.npz"))
        resumed = _mesh_run(device, run, steps=8, checkpoint_dir=d,
                            checkpoint_every=9, resume=True)
    _check(resumed["resumed_from"] == 4,
           f"the bit-flipped step 8 was not rejected: resumed from "
           f"{resumed['resumed_from']}")
    _check(clean["digest"] == resumed["digest"],
           "resume-from-fallback differs from the uninterrupted run")
    return ("bit-flipped newest checkpoint rejected by CRC; resume "
            "recomputed from step 4 bit-exactly" + _memory(resumed))


def leg_transient_io(device) -> str:
    tree = _demo_tree(1, device)
    with tempfile.TemporaryDirectory() as d:
        sess = CheckpointSession(
            d, retries=3, backoff=0.0,
            fault_injector=TransientIO("array_write", times=2),
            sleep=lambda s: None)
        sess.save(4, {"state": tree})
        _check(sess.io_retries == 2,
               f"expected 2 retried OSErrors, counted {sess.io_retries}")
        _check(sess.latest_intact() == 4, "retried save not intact")
    with tempfile.TemporaryDirectory() as d:
        sess = CheckpointSession(
            d, retries=2, backoff=0.0,
            fault_injector=TransientIO("array_write", times=10),
            sleep=lambda s: None)
        exhausted = False
        try:
            sess.save(4, {"state": tree})
        except InjectedIOError:
            exhausted = True
        _check(exhausted, "retry exhaustion did not surface the OSError")
        _check(CheckpointSession(d).latest_intact() is None,
               "failed save left an 'intact' checkpoint")
    return "2 transient OSErrors retried to success; exhaustion surfaces"


def leg_store_partial(device) -> str:
    from repro_torch.checkpoint.store import OuterWeightStore

    like = _demo_tree(2, device)
    with tempfile.TemporaryDirectory() as d:
        store = OuterWeightStore(d)
        trees = {c: _demo_tree(10 + c, device) for c in (1, 2, 3)}
        for c, t in trees.items():
            store.save(c, t)
        truncate_file(store._path(2), frac=0.5)
        bad = store.verify()
        _check(list(bad) == [2], f"verify flagged {sorted(bad)} != [2]")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            avg = store.window_average(3, window=3, like=like)
        _check(any("skipping unreadable" in str(w.message)
                   for w in caught), "no skip warning for the torn cycle")
        err = max(float((avg[k].cpu().double()
                         - (trees[1][k].cpu().double()
                            + trees[3][k].cpu().double()) / 2).abs().max())
                  for k in like)
        _check(err < 1e-6,
               "window average did not renormalize over readable cycles")
    with tempfile.TemporaryDirectory() as d:
        store = OuterWeightStore(d, keep_last=2)
        for c in range(1, 5):
            store.save(c, like)
        _check(store.cycles() == [3, 4],
               f"retention kept {store.cycles()} != [3, 4]")
    return "torn outer checkpoint skipped+warned; keep_last=2 retains [3,4]"


def leg_session_gc(device) -> str:
    tree = _demo_tree(3, device)
    with tempfile.TemporaryDirectory() as d:
        sess = CheckpointSession(d, keep=2)
        for step in (4, 8, 12):
            sess.save(step, {"state": tree})
        _check(sess.steps() == [8, 12],
               f"gc kept {sess.steps()} != [8, 12]")
        _check(sess.latest_intact() == 12, "newest survivor not intact")
    return "keep=2 retains [8, 12]; newest survivor verifies"


def default_legs() -> list[Leg]:
    return [
        Leg("masked-parity", leg_masked_parity, smoke=True),
        Leg("nan-replica", leg_nan_replica),
        Leg("resume-exact", leg_resume_exact, smoke=True),
        Leg("kill-mid-save", leg_kill_mid_save, smoke=True),
        Leg("corrupt-fallback", leg_corrupt_fallback),
        Leg("transient-io", leg_transient_io, smoke=True),
        Leg("store-partial", leg_store_partial),
        Leg("session-gc", leg_session_gc),
    ]


# ------------------------------------------------------------- harness


def run_leg(leg: Leg, device) -> dict:
    try:
        return {"ok": True, "detail": leg.run(device)}
    except SimulatedCrash as e:     # a leg leaked its own injected crash
        return {"ok": False, "error": f"leaked SimulatedCrash: {e}"}
    except Exception as e:          # noqa: BLE001 - a leg's verdict
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def run_fault_check(legs: list[Leg] | None = None, smoke: bool = False,
                    log=print, device=None) -> dict:
    dev = resolve_device(device)
    legs = default_legs() if legs is None else legs
    if smoke:
        legs = [leg for leg in legs if leg.smoke]
    results = {}
    for leg in legs:
        log(f"fault-check: {leg.name} ...")
        results[leg.name] = run_leg(leg, dev)
        r = results[leg.name]
        log(f"fault-check: {leg.name}: {'ok' if r['ok'] else 'FAIL'} — "
            f"{r.get('detail', r.get('error'))}")
    return {"legs": results, "smoke": smoke, "device": str(dev),
            "ok": all(r["ok"] for r in results.values())}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.resilience.check",
        description="Deterministic fault-injection harness: the alive "
                    "mask, NaN poisoning across processes, exact resume, "
                    "kill-mid-save, bit flips, transient IO, torn outer "
                    "checkpoints, retention — each leg a hard pass/fail "
                    "scenario.")
    ap.add_argument("--smoke", action="store_true",
                    help=f"the smoke subset (also via {SMOKE_ENV}=1)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--only", metavar="SUBSTR", default=None,
                    help="run only legs whose name contains SUBSTR")
    ap.add_argument("--list", action="store_true",
                    help="list leg names and exit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    smoke = args.smoke or os.environ.get(SMOKE_ENV) == "1"
    legs = default_legs()
    if args.list:
        for leg in legs:
            print(("[smoke] " if leg.smoke else "        ") + leg.name)
        return 0
    if args.only:
        legs = [leg for leg in legs if args.only in leg.name]
        if not legs:
            print(f"no fault leg matches {args.only!r}", file=sys.stderr)
            return 2
    report = run_fault_check(legs, smoke=smoke, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"report written to {args.json}")
    n = len(report["legs"])
    if report["ok"]:
        print(f"fault-check: ALL_OK ({n} legs)")
        return 0
    failed = [k for k, r in report["legs"].items() if not r["ok"]]
    print(f"fault-check: FAILED ({len(failed)}/{n}): {', '.join(failed)}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
