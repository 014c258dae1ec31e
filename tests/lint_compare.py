"""The port's lint beside the reference's, for ``tests/test_torch_lint_*.py``
(one file a mesh shape): the port's cases run through
``repro_torch.analysis.lint.run_lint`` on the CPU while the reference's
run in a subprocess that forces 8 host devices (``tests/lint_reference.py``),
waited on from a thread that runs no torch op.

The reports are held to each other on four things, for each case the
reference builds on this jax: each pass's verdict (``manual_hazard``: the
reference's ok against the port's skipped; ``launch_budget``: the
reference's counted against the port's skipped on the CPU), the
collective census a level and op, the payload dtypes a level and the
launch counts, the port's a kernel a layer where the reference counts
one ``pallas_call`` inside its layer scan. Two differences are the
port's by design and pinned here as such:

- :data:`WIRE`: a compressed bf16 payload crosses as its ``uint8`` view
  (``gloo`` and NCCL have no 16-bit integer type), where the reference's
  crosses as ``u16``;
- :data:`STAND_INS`: the GSPMD cases run the one-process stacked
  ``core.hwa`` step; the one the reference builds here,
  ``sync/flat-vmap-k4-kernel``, shards its 4 replicas over 2 replica
  devices (one all-reduce, the mean kernel and the push), where the
  port's 4 replicas sit in one process (no collective, one fused launch).
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

#: the reference's cases that do not build on jax >= 0.8, and the error
#: each gives (ROADMAP "Tests": ``compat.shard_map`` refuses ``auto=``,
#: ``with_sharding_constraint`` refuses Explicit axes)
ERRORING = {
    "train/mesh-native@2x2x2":
        "NotImplementedError: this jax's shard_map has no auto= keyword",
    "train/hwa-vmap@2x2x2":
        "ValueError: The spec of NamedSharding passed to "
        "with_sharding_constraint can only refer to Auto axes",
    "sync/legacy-kernel@1dev":
        "ValueError: The spec of NamedSharding passed to "
        "with_sharding_constraint can only refer to Auto axes",
}
#: the reference's GSPMD cases, run by the port's one-process stand-ins
STAND_INS = {"train/hwa-vmap@2x2x2", "sync/flat-vmap-k4-kernel@2x2x2",
             "sync/legacy-kernel@1dev"}
#: the reference's wire-view token -> the port's
WIRE = {"u16": "u8"}
#: attention layers of the smoke granite-3-2b: the port's train and
#: decode launch budgets are the reference's count times these
ATTN_LAYERS = 2


def reference(subs, dst):
    """The reference's lint of the cases matching ``subs``, in a
    subprocess (no torch op in this thread)."""
    root = os.path.dirname(HERE)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(HERE, "lint_reference.py"),
                    dst] + list(subs), env=env, check=True, timeout=600,
                   capture_output=True)
    with open(dst) as f:
        return json.load(f)


def run_both(select, subs, tmp_path):
    """(the port's report, its facts, the reference's cases): the port's
    lint of the cases ``select`` keeps, beside the reference's of those
    matching ``subs``."""
    from repro_torch.analysis import lint
    cases = [c for c in lint.default_cases() if select(c)]
    facts = {}
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(reference, subs, str(tmp_path / "ref.json"))
        report = lint.run_lint(cases, device="cpu", facts=facts,
                               log=lambda *_: None)
        return report, facts, ref.result()


def scaled(name, n_ref):
    """The reference's launch count in the port's terms."""
    return n_ref * ATTN_LAYERS if name.split("/")[0] in ("train", "serve") \
        else n_ref


def assert_agrees(name, report, facts, ref):
    """The four agreements for one case the reference builds."""
    entry, r = report["bundles"][name], ref[name]
    assert "error" not in r["entry"], r["entry"]
    for p, want in r["entry"]["passes"].items():
        got = entry["passes"][p]
        assert got["ok"] == want["ok"], (p, got, want)
    assert entry["passes"]["manual_hazard"]["skipped"]
    f = facts[name]
    payloads = {lvl: sorted({WIRE.get(t, t) for t in ts})
                for lvl, ts in r["payloads"].items()}
    launches = sum((f["declared_launches"] or {}).values())
    if name in STAND_INS:
        # the sharded stack's one replica all-reduce and two launches
        # against the process-local stack's none and one fused launch
        assert (r["census"], payloads, r["launches"]) == (
            {"replica": {"all_reduce": 1}}, {"replica": ["f32"]}, 2)
        assert (f["census"]["collectives"], f["census"]["payloads"],
                f["declared_launches"]) == ({}, {}, {"wa_sync_fused": 1})
        return
    assert f["census"]["collectives"] == r["census"]
    assert f["census"]["payloads"] == payloads
    assert launches == scaled(name, r["launches"])
