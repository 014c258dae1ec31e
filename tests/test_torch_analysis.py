"""The port's contract checker (``repro_torch.analysis``), the
counterparts of ``tests/test_analysis.py``:

- the contract factories and the ledger view of a census;
- the report's round trip, ``report_ok`` and ``summarize``;
- one seeded violation a pass, each failing its pass and making
  ``python -m repro_torch.analysis.lint`` exit nonzero: a bundle that
  declares a launch it never makes (the counts injected, as the CPU
  launches none), a sync that issues an extra ``all_gather``, an f64 op,
  an f32 payload where the ``u8`` view is declared, a sync that rebinds
  its ring to a fresh tensor (the collectives and payload cases in one
  spawn of 2 ``gloo`` ranks);
- a build that raises becomes an ``error`` entry;
- ``manual_hazard`` is always skipped, with its reason;
- the declared working sets, and a peak over one failing the donation
  pass (the peak injected, as the CPU measures none; the card's own
  reading is held in ``tests/test_torch_cuda.py``);
- an f64 op in a backward fails the dtype pass.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.analysis import lint, passes
from repro_torch.analysis.contracts import (DEFAULT_CONTRACT, PEAK_SLACK,
                                            BundleContract,
                                            CollectiveContract,
                                            DonationPolicy, DtypePolicy,
                                            LaunchBudget, decode_contract,
                                            dtype_token, sync_contract,
                                            train_contract)
from repro_torch.analysis.passes import (PASS_NAMES, BundleArtifacts,
                                         donation_pass, dtype_pass,
                                         launch_budget_pass, record_call,
                                         run_passes)
from repro_torch.analysis.report import (build_report, bundle_entry,
                                         report_ok, summarize, to_json)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: the seeded cases, by the pass each must fail
SEEDED = {"seeded/launch-never-made@1dev": "launch_budget",
          "seeded/extra-all-gather@flat": "collectives",
          "seeded/f64-op@1dev": "dtype",
          "seeded/f32-payload-for-u8@flat": "dtype",
          "seeded/ring-rebound@1dev": "donation"}
#: where the seeded lint matrix comes from, in this process and in ranks
FACTORY = "test_torch_analysis:seeded_cases"


# ------------------------------------------------------------ contracts


def test_contract_factories():
    c = sync_contract(("replica",), launches={"wa_window_update": 1})
    assert c.collectives.ops == {"all_reduce": 1}
    assert c.launch == LaunchBudget.exact({"wa_window_update": 1})
    assert c.launch.counts == {"wa_window_update": 1}
    assert c.dtypes.collective_dtypes == ("f32",)
    t = train_contract(replica_axes=("pod", "replica"))
    assert t.collectives.assembly_free is False
    assert t.launch is None and t.dtypes.forbid == ("f64",)
    pinned = train_contract(("replica",), launches={},
                            other_ops={"model": {"all_reduce": 3}})
    assert pinned.collectives.assembly_free and pinned.launch.counts == {}
    d = decode_contract(launches={"paged_attention": 2})
    assert d.collectives.census(("replica",)) == {}
    assert d.launch.violations({"paged_attention": 1}) == [
        "paged_attention launched 1 time(s), budget [2, 2]"]
    assert DEFAULT_CONTRACT.collectives is None
    assert dtype_token(torch.bfloat16) == "bf16"
    assert dtype_token(torch.float8_e4m3fn) == "f8e4m3fn"
    assert dtype_token(torch.uint8) == "u8"


def test_census_and_its_ledger_view():
    """One psum a level in the census; the ledger counts its two-way
    rounds (2^m ranks: m), an all-gather once; the outer and health
    levels named in the mesh's order."""
    c = CollectiveContract(axis="replica", ops={"all_reduce": 2},
                           outer_axis="pod", outer_ops={"all_gather": 2},
                           other_ops={"model+data": {"all_reduce": 1}})
    order = ("pod", "replica", "data", "model")
    assert c.census(order) == {"replica": {"all_reduce": 2},
                               "pod": {"all_gather": 2},
                               "data+model": {"all_reduce": 1}}
    shape = {"pod": 2, "replica": 4, "data": 2, "model": 2}
    assert c.ledger(shape) == {"replica": {"all_reduce": 4},
                               "pod": {"all_gather": 2},
                               "data+model": {"all_reduce": 2}}


# --------------------------------------------------------------- report


def _entry(**kw):
    return bundle_entry(run_passes(BundleArtifacts(**kw), DEFAULT_CONTRACT))


def test_report_round_trip_and_ok():
    rep = build_report({"case": _entry()})
    assert rep["ok"] and report_ok(rep)
    rt = json.loads(to_json(rep))
    assert report_ok(rt) == report_ok(rep)
    assert set(rt) == {"bundles", "n_bundles", "n_violations", "ok",
                       "schema", "smoke"}
    assert list(rep["bundles"]["case"]["passes"]) == list(PASS_NAMES)
    assert set(rt["bundles"]["case"]["passes"]) == set(PASS_NAMES)
    assert "OK hwa-lint" in summarize(rt)
    # an empty report is NOT ok (a matrix filtered to nothing must fail)
    assert not report_ok(build_report({}))
    rep2 = build_report({"a": _entry(), "b": bundle_entry([], error="boom")})
    assert not report_ok(rep2) and rep2["n_violations"] == 1
    assert "ERROR b" in summarize(rep2)


def test_manual_hazard_is_skipped_with_its_reason():
    (res,) = run_passes(BundleArtifacts(), DEFAULT_CONTRACT,
                        ("manual_hazard",))
    assert res.ok and res.skipped
    assert "no SPMD partitioner" in res.evidence[0]


def test_a_crashing_build_is_an_error_entry():
    def boom(ctx):
        raise RuntimeError("no such mesh")
    rep = lint.run_lint([lint.LintCase("synthetic/crash", build=boom)],
                        device="cpu", log=lambda *_: None)
    entry = rep["bundles"]["synthetic/crash"]
    assert not entry["ok"] and "no such mesh" in entry["error"]
    assert not report_ok(rep)


# -------------------------------------------------- the seeded violations


def _stacked(ctx):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.hwa import HWAConfig
    from repro_torch.models.registry import build_model
    lm = build_model(get_smoke_config("granite-3-2b"))
    return lint._stacked_sync(lm, HWAConfig(n_replicas=2, window=3))(ctx)


def _flat(ctx):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.hwa import HWAConfig
    from repro_torch.models.registry import build_model
    lm = build_model(get_smoke_config("granite-3-2b"))
    return lint._mesh_sync(lm, HWAConfig(n_replicas=2, window=3))(ctx)


def _launch_never_made(ctx):
    bundle, args = _stacked(ctx)
    return dataclasses.replace(bundle, contract=dataclasses.replace(
        bundle.contract, launch=LaunchBudget.exact({"wa_sync_fused": 1}))), \
        args


def _extra_all_gather(ctx):
    bundle, args = _flat(ctx)
    inner = bundle.fn

    def fn(params, ws, cycle):
        ctx.mesh.all_gather(ws.total[:8], ("replica",))
        return inner(params, ws, cycle)
    return dataclasses.replace(bundle, fn=fn), args


def _f64_op(ctx):
    bundle, args = _stacked(ctx)
    inner = bundle.fn

    def fn(*a):
        out = inner(*a)
        a[0]["embed"].double().sum()        # a stray f64 reduction
        return out
    return dataclasses.replace(bundle, fn=fn), args


def _f32_payload(ctx):
    bundle, args = _flat(ctx)
    return dataclasses.replace(bundle, contract=dataclasses.replace(
        bundle.contract, dtypes=DtypePolicy(collective_dtypes=("u8",)))), \
        args


def _ring_rebound(ctx):
    bundle, args = _stacked(ctx)
    inner = bundle.fn

    def fn(*a):
        out = list(inner(*a))
        out[2] = dataclasses.replace(out[2], ring=out[2].ring.clone())
        return tuple(out)
    return dataclasses.replace(bundle, fn=fn), args


def seeded_cases(cfg=None):
    """The seeded matrix (a ``lint.CASES`` factory)."""
    flat = {"replica": 2}
    return [
        lint.LintCase("seeded/launch-never-made@1dev", _launch_never_made),
        lint.LintCase("seeded/extra-all-gather@flat", _extra_all_gather,
                      mesh=flat),
        lint.LintCase("seeded/f64-op@1dev", _f64_op),
        lint.LintCase("seeded/f32-payload-for-u8@flat", _f32_payload,
                      mesh=flat),
        lint.LintCase("seeded/ring-rebound@1dev", _ring_rebound)]


def _seed(mp):
    """The seeded matrix as the lint's; the CPU's launch counts injected
    as the card's (none made)."""
    mp.setattr(lint, "CASES", FACTORY)
    record = passes.record_call

    def injected(bundle, args, **kw):
        out, art = record(bundle, args, **kw)
        art.launches = {}
        return out, art
    mp.setattr(passes, "record_call", injected)


@pytest.fixture
def seeded(monkeypatch):
    _seed(monkeypatch)


@pytest.fixture(scope="module")
def seeded_report():
    with pytest.MonkeyPatch.context() as mp:
        _seed(mp)
        return lint.run_lint(device="cpu", log=lambda *_: None)


@pytest.mark.parametrize("case", list(SEEDED))
def test_seeded_violation_fails_its_pass(seeded_report, case):
    entry = seeded_report["bundles"][case]
    assert "error" not in entry, entry
    failing = {p for p, r in entry["passes"].items() if not r["ok"]}
    assert failing == {SEEDED[case]}, entry
    assert entry["passes"][SEEDED[case]]["violations"]


def test_seeded_violation_messages(seeded_report):
    b = seeded_report["bundles"]
    v = {n: " ".join(b[n]["passes"][p]["violations"])
         for n, p in SEEDED.items()}
    assert "wa_sync_fused launched 0 time(s)" in \
        v["seeded/launch-never-made@1dev"]
    assert "expected 0 × all_gather, found 1" in \
        v["seeded/extra-all-gather@flat"]
    assert "forbidden dtype f64" in v["seeded/f64-op@1dev"]
    assert "payload dtype f32 not in allowed ['u8']" in \
        v["seeded/f32-payload-for-u8@flat"]
    assert "rebound to a fresh tensor" in v["seeded/ring-rebound@1dev"]
    assert not report_ok(seeded_report)


@pytest.mark.parametrize("case", [c for c in SEEDED if c.endswith("@1dev")])
def test_seeded_violation_fails_the_cli(seeded, case, capsys):
    assert lint.main(["--device", "cpu", "--only", case]) == 1
    assert f"FAIL {case}" in capsys.readouterr().out


def test_seeded_mesh_violations_fail_the_cli(seeded, capsys):
    assert lint.main(["--device", "cpu", "--only", "@flat"]) == 1
    out = capsys.readouterr().out
    assert "FAIL seeded/extra-all-gather@flat" in out
    assert "FAIL seeded/f32-payload-for-u8@flat" in out


def test_injected_launch_counts():
    """On the card a wrapper counts its launches: a call that launched
    what it declared passes, one that launched nothing fails."""
    budget = BundleContract(launch=LaunchBudget.exact({"wa_sync_fused": 1}))
    assert launch_budget_pass(
        BundleArtifacts(launches={"wa_sync_fused": 1}), budget).ok
    assert not launch_budget_pass(BundleArtifacts(launches={}), budget).ok
    assert launch_budget_pass(BundleArtifacts(), budget).skipped


def test_declared_working_sets():
    """A sync's declared working set in packed f32 blocks of the rank
    (``packed.packed_sync_working_set``), plus PEAK_SLACK: 3 for an f32
    sync, 4 for a grouped layout, 5.5 and 5.75 with bf16 and fp8 wire
    views over 2 pods, 6 over a level of 3 ranks (gathered and summed),
    1 for the inner sync; the stacked fused sync K + 1, or one block
    and 2K of its largest leaf where the divergence metric's phase is
    the larger (one leaf)."""
    from repro_torch.common.packing import pack_spec
    from repro_torch.core.hwa import HWAConfig
    from repro_torch.launch.sync.packed import packed_sync_working_set as ws
    B = 1 << 30
    assert ws(B, [2]) == 3 * B + PEAK_SLACK
    assert ws(B, [2, 1], grouped=True) == 4 * B + PEAK_SLACK
    assert ws(B, [2, 2], comms_dtype="bf16",
              ring_dtype="bf16") == int(5.5 * B) + PEAK_SLACK
    assert ws(B, [2, 2], comms_dtype="fp8",
              ring_dtype="fp8") == int(5.75 * B) + PEAK_SLACK
    assert ws(B, [3]) == 6 * B + PEAK_SLACK
    assert ws(B, [2], push=False) == B + PEAK_SLACK
    hwa4k = HWAConfig(n_replicas=4, window=3, use_kernels=True)
    params = {k: torch.zeros(4096) for k in "abcd"}
    block = 4 * pack_spec(params).padded
    fused = lint.stacked_sync_bundle(hwa4k, params)
    assert fused.contract.donation.peak_bytes == 5 * block + PEAK_SLACK
    one = {"w": torch.zeros(4096)}
    assert lint.stacked_sync_bundle(hwa4k, one).contract.donation \
        .peak_bytes == 4 * pack_spec(one).padded + 8 * 4 * 4096 + PEAK_SLACK
    plain = lint.stacked_sync_bundle(HWAConfig(n_replicas=4, window=3),
                                     params)
    assert plain.contract.donation.peak_bytes is None


def test_injected_peak_over_the_working_set():
    """On the card the recorder reads the call's peak above its start: at
    its declared working set the pass holds, a byte over it fails (a
    buffer made and dropped inside the call); off the card it is not
    measured."""
    c = BundleContract(donation=DonationPolicy(peak_bytes=100))
    assert donation_pass(BundleArtifacts(peak_above_start=100), c).ok
    bad = donation_pass(BundleArtifacts(peak_above_start=101), c)
    assert not bad.ok
    assert "exceeds the declared working set 100 B" in bad.violations[0]
    off = donation_pass(BundleArtifacts(), c)
    assert off.ok and "not measured" in off.evidence[-1]


class _Widen(torch.autograd.Function):
    """Doubles its input; its backward (seeded) goes through f64."""
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return (g.double() * 2).float()


def test_f64_in_a_backward_fails_the_dtype_pass():
    from repro_torch.launch.sync.bundles import StepBundle

    def fn(x):
        _Widen.apply(x).sum().backward()
        return x.grad
    x = torch.ones(8, requires_grad=True)
    _, art = record_call(StepBundle(fn=fn), (x,))
    res = dtype_pass(art, BundleContract())
    assert not res.ok and "forbidden dtype f64" in res.violations[0]
