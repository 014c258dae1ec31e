"""The port's spans and counters (``repro_torch.common.trace``): nothing
while no profiler runs, the phases of the HWA step, the sync and the
expert layer nested by name while one does, host stamps on the
profiler's own clock, one session in the registry, and the expert
counter against the routing.

The last test is marked ``cuda`` and skips without a card; on the card,
from the repo root (this file imports no JAX):

    python -m pytest --noconftest -q tests/test_torch_trace.py
"""
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.common import trace
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.configs import get_smoke_config
from repro_torch.core.hwa import HWAConfig, hwa_init, hwa_inner_step, \
    hwa_sync
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.optim import sgd
from repro_torch.train.trainer import lm_task
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K = 2
MOE = "granite-moe-1b-a400m"


def _setup(arch=MOE, remat="full", device="cpu", **over):
    cfg = get_smoke_config(arch).with_(remat=remat, **over)
    lm = build_model(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(0),
                     device=device)
    hc = HWAConfig(n_replicas=K, sync_period=2, window=3, use_kernels=True)
    opt = sgd(momentum=0.9, weight_decay=5e-4)
    state = hwa_init(hc, params, opt)
    rows = torch.randint(0, cfg.vocab_size, (K, 2, 9),
                         generator=torch.Generator().manual_seed(1)
                         ).to(device)
    batch = (rows[..., :-1].contiguous(), rows[..., 1:].contiguous())
    return cfg, hc, opt, state, batch, lm_task(lm, None).loss_fn


def _clone(state):
    return tree_map(lambda x: x.clone(), state)


def _run(hc, opt, state, batch, loss_fn):
    """A step and a sync: (state, step metrics, sync metrics)."""
    state, m = hwa_inner_step(hc, state, batch, loss_fn, opt, 0.1)
    state, s = hwa_sync(hc, state)
    return state, m, s


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(recs):
    by_id = {r["id"]: r for r in recs}
    return [(r["name"], None if r["parent"] is None
             else by_id[r["parent"]]["name"]) for r in recs]


def _bits_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_no_profiler_records_nothing_and_changes_no_bit(monkeypatch):
    _, hc, opt, state, batch, loss_fn = _setup()
    with _cpu_profile():                   # a session to leave unchanged
        ref_state, ref_m, ref_s = _run(hc, opt, _clone(state), batch,
                                       loss_fn)
    before = trace.records()
    entered = []
    real = torch.profiler.record_function

    def spy(*a, **kw):
        entered.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    out_state, out_m, out_s = _run(hc, opt, _clone(state), batch, loss_fn)
    p = get_smoke_config(MOE).with_(remat="none")
    layer = tree_map(lambda x: x[0], state.wa["stack"][0]["moe"])
    x = torch.randn(2, 8, p.d_model, generator=torch.Generator()
                    .manual_seed(2))
    y, aux = moe.moe_forward(p, layer, x)
    assert entered == []
    assert trace.records() == before
    assert trace._REG.stack == []
    assert _bits_equal(out_state, ref_state)
    assert _bits_equal(out_m, ref_m) and _bits_equal(out_s, ref_s)
    with _cpu_profile():
        y2, aux2 = moe.moe_forward(p, layer, x)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


def test_spans_nest_as_the_phases():
    _, hc, opt, state, batch, loss_fn = _setup(remat="full")
    with _cpu_profile():
        _run(hc, opt, state, batch, loss_fn)
    recs = trace.records()
    tree = _tree(recs)
    step = [r for r in recs if r["root"] == "hwa.step"]
    for phase in ("forward", "backward", "update"):
        mine = [r for r in step if r["name"] == "hwa.step." + phase]
        assert [r["args"] for r in mine] == [{"k": k} for k in range(K)]
        assert {p for n, p in tree if n == "hwa.step." + phase} \
            == {"hwa.step"}
    assert tree.count(("hwa.step", None)) == 1
    layers = get_smoke_config(MOE).n_layers
    for name in ("moe.dispatch", "moe.combine"):
        # each layer of each replica, in the forward and again in the
        # remat recompute under the backward
        assert tree.count((name, "hwa.step.forward")) == K * layers
        assert tree.count((name, "hwa.step.backward")) == K * layers
    sync = [(n, p) for (n, p), r in zip(tree, recs)
            if r["root"] == "hwa.sync"]
    assert sync == [("hwa.sync", None), ("hwa.sync.divergence", "hwa.sync"),
                    ("hwa.sync.pack", "hwa.sync"),
                    ("hwa.sync.restart", "hwa.sync"),
                    ("hwa.sync.restart", "hwa.sync")]
    assert {r["index"] for r in recs} == {0}
    for r in recs:
        assert r["start_ns"] <= r["end_ns"] and r["device_ms"] is None


def test_without_remat_the_expert_spans_are_the_forwards():
    _, hc, opt, state, batch, loss_fn = _setup(remat="none")
    with _cpu_profile():
        hwa_inner_step(hc, state, batch, loss_fn, opt, 0.1)
    tree = _tree(trace.records())
    layers = get_smoke_config(MOE).n_layers
    assert tree.count(("moe.dispatch", "hwa.step.forward")) == K * layers
    assert ("moe.dispatch", "hwa.step.backward") not in tree


def test_host_stamps_on_the_profilers_clock():
    _, hc, opt, state, batch, loss_fn = _setup()
    with _cpu_profile() as prof:
        _run(hc, opt, state, batch, loss_fn)
    recs = trace.records()
    names = {r["name"] for r in recs}
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names and e.device_type() == \
                torch.autograd.DeviceType.CPU:
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in names:
        mine = sorted((r["start_ns"], r["end_ns"]) for r in recs
                      if r["name"] == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs)
        for (s0, e0), (s1, e1) in zip(mine, theirs):
            # the registry's stamps bracket the profiler's range
            assert abs(s1 - s0) < 1_000_000 and abs(e1 - e0) < 1_000_000
            assert s0 <= s1 and e1 <= e0


def test_a_second_session_clears_the_first():
    _, hc, opt, state, batch, loss_fn = _setup(remat="none")
    with _cpu_profile():
        _run(hc, opt, state, batch, loss_fn)
        hwa_inner_step(hc, state, batch, loss_fn, opt, 0.1)
    first = trace.records()
    assert sorted({(r["root"], r["index"]) for r in first}) == [
        ("hwa.step", 0), ("hwa.step", 1), ("hwa.sync", 0)]
    assert trace.summary()["counters"]["moe.expert_pairs"]["calls"] > 0
    with _cpu_profile():
        hwa_sync(hc, state)
    second = trace.records()
    assert [r["name"] for r in second] == [
        "hwa.sync", "hwa.sync.divergence", "hwa.sync.pack",
        "hwa.sync.restart", "hwa.sync.restart"]
    assert second[0]["index"] == 0 and second[0]["id"] == 0
    assert trace.summary()["counters"] == {}


def test_summary_self_time_and_calls():
    with _cpu_profile():
        with trace.span("a"):
            with trace.span("a.b", k=0):
                pass
            with trace.span("a.b", k=1):
                pass
    s = trace.summary()["spans"]
    assert s["a"]["calls"] == 1 and s["a.b"]["calls"] == 2
    assert s["a"]["device_ms"] is None
    assert s["a"]["self_ms"] == pytest.approx(
        s["a"]["host_ms"] - s["a.b"]["host_ms"], abs=1e-9)
    assert s["a.b"]["self_ms"] == pytest.approx(s["a.b"]["host_ms"])


def test_one_stack_for_the_process():
    """A span opened on another thread (as the autograd engine's, which
    runs the remat recompute on the card) nests under the span open on
    the calling thread."""
    def worker():
        with trace.span("inner"):
            pass
    with _cpu_profile():
        with trace.span("outer"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    recs = trace.records()
    assert _tree(recs) == [("outer", None), ("inner", "outer")]
    assert recs[0]["thread"] != recs[1]["thread"]


def test_expert_pairs_counts_the_groups():
    cfg = get_smoke_config(MOE)
    params = build_model(cfg).init(torch.Generator().manual_seed(3),
                                   device="cpu")
    layer = tree_map(lambda x: x[0], params["stack"][0]["moe"])
    xs = [torch.randn(2, 8, cfg.d_model,
                      generator=torch.Generator().manual_seed(s))
          for s in (4, 5)]
    with _cpu_profile():
        for x in xs:
            moe.moe_forward(cfg, layer, x)
    got = trace.summary()["counters"]["moe.expert_pairs"]
    big = mean = 0.0
    for x in xs:
        _, top_i, _ = moe._route(cfg, layer, x.reshape(-1, cfg.d_model))
        counts = torch.bincount(top_i.reshape(-1),
                                minlength=cfg.n_experts).float()
        big += float(counts.max())
        mean += float(counts.mean())
    assert got["calls"] == len(xs)
    assert got["value"] == pytest.approx([big, mean], rel=1e-6)


@pytest.mark.cuda
def test_each_spans_kernels_start_after_its_host_start():
    """On the card: every kernel launched inside a span starts on the
    device at or after the span's host start, on the trace's clock (the
    profiler aligns the device's stamps to the host's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the spans' CUDA events and the "
                    "device trace exist only on the card)")
    _, hc, opt, state, batch, loss_fn = _setup(
        device="cuda", dtype="bfloat16")
    _run(hc, opt, state, batch, loss_fn)          # builds and warms up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run(hc, opt, state, batch, loss_fn)
        torch.cuda.synchronize()
    recs = trace.records()
    cpu = torch.autograd.DeviceType.CPU
    launches, device = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu:
            if e.name().startswith(("cuda", "cuLaunch")):
                launches[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            device.append((e.correlation_id(), e.start_ns(), e.name()))
    launched = [(launches[c], s, n) for c, s, n in device
                if c and c in launches]
    assert len(launched) > 0.9 * len(device) > 0
    names = {r["name"] for r in recs}
    assert {"hwa.step.forward", "hwa.sync.pack", "moe.dispatch",
            "moe.combine"} <= names
    seen = 0
    for r in recs:
        mine = [(s, t, n) for t, s, n in launched
                if r["start_ns"] <= t <= r["end_ns"]]
        if mine:
            seen += 1
            s, t, n = min(mine)
            assert s >= r["start_ns"], (r["name"], s - r["start_ns"],
                                        t - r["start_ns"], n)
        assert r["device_ms"] is not None and r["device_ms"] >= 0.0
    assert seen >= len(recs) // 2
