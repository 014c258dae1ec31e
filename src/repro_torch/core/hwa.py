"""Hierarchical Weight Averaging — the paper's training framework.

Counterpart of ``repro.core.hwa`` (the single-device stacked functions).
State machine (Algorithms 1 & 2):

  every step   : each of the K replicas takes one optimizer step on its own
                 batch (different sampling orders)           [hwa_inner_step]
  every H steps: W̄_e = mean_k W^k ; every replica ← W̄_e ;
                 slide-window update → W̿_e                   [hwa_sync]

``inner`` is stacked on a leading K axis as in the reference, so the sync
packs it with one copy. Where the reference vmaps one replica's step over
K, the port loops over the replicas in Python: each step differentiates a
detached view ``inner[k]`` and writes the update back in place, which is
the same math with one replica's gradients alive at a time (and lets the
flash kernels, called through ``ctypes``, need no batching rule).
``inner``, ``inner_opt`` and the window buffers are updated in place;
the functions return the state for the reference's calling pattern.

Every window of the reference is ported: the f32 ring, the bf16 and fp8
rings (``hwa_init(ring_dtype=...)``), the sparse stride and the
streaming window, and the resilient sync (``HWAConfig.resilient``: the
alive-masked mean of ``resilience.health``). As in the reference, the
stacked path ignores ``outer_every``: the two-level tree is the
mesh-native path's (``launch.sync``), whose builders refuse a value that
disagrees with their topology. :func:`hwa_local_inner_step` is one
replica's step there, a rank's whole train step.

The stacked step and sync are ``common.trace`` spans while a profiler
runs: ``hwa.step`` with each replica's ``forward``, ``backward`` and
``update``; ``hwa.sync`` with its ``divergence``, ``pack`` and
``restart``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common import trace
from repro_torch.common.packing import pack, pack_stacked, unpack
from repro_torch.common.pytree import register_dataclass, tree_flatten, \
    tree_leaves, tree_mean_axis0, tree_unflatten
from repro_torch.core.offline import (WindowState, window_average_packed,
                                      window_init, window_scalars,
                                      window_update_packed)
from repro_torch.core.online import (broadcast_to_replicas, online_average,
                                     replica_divergence, restart_replicas)
from repro_torch.kernels import wa_update
from repro_torch.optim.base import Optimizer, apply_updates
from repro_torch.resilience.health import (masked_mean_axis0,
                                           quarantine_opt_state,
                                           replica_alive_mask)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class HWAConfig:
    n_replicas: int = 2          # K (paper Table IV: 2-4; K=2 suffices)
    sync_period: int = 0         # H; 0 → one epoch (paper default H = N/B)
    window: int = 20             # I (paper Fig. 13: {20, 50})
    window_stride: int = 1       # sparse window (§III-B): every J-th cycle
    window_kind: str = "ring"    # ring | streaming
    avg_opt_state: bool = False  # also average optimizer moments at sync
    use_kernels: bool = False    # the WA kernels (fused or two-launch)
    outer_every: int = 1         # H₂ of the two-level sync tree (mesh only)
    resilient: bool = False      # alive-masked elastic mean: a NaN'd or
                                 # diverged replica is left out of W̄ and
                                 # restarts from it with zeroed optimizer
                                 # slots (resilience.health)
    max_param_rms: float | None = None
                                 # resilient only: a replica whose RMS
                                 # over all its parameters exceeds this is
                                 # quarantined too (None: finiteness only)


@dataclasses.dataclass
class HWAState:
    inner: PyTree                # (K, ...) stacked replica params
    inner_opt: PyTree            # (K, ...) stacked optimizer state
    window_state: WindowState    # offline module state
    wa: PyTree                   # current W̿ (unstacked)
    cycle: torch.Tensor          # e — completed synchronization cycles
    step: torch.Tensor           # i — global optimizer steps taken


register_dataclass(HWAState, data_fields=["inner", "inner_opt",
                                          "window_state", "wa", "cycle",
                                          "step"])


def hwa_init(cfg: HWAConfig, params: PyTree, optimizer: Optimizer,
             ring_dtype=torch.float32) -> HWAState:
    """All replicas start from the same initialization (Algorithm 1 line
    1 with a shared init); they diverge through data order.
    ``ring_dtype`` (a dtype or a ``f32``/``bf16``/``fp8`` token) selects
    the compressed window ring (``core.offline.window_init``)."""
    dev = tree_leaves(params)[0].device
    inner = broadcast_to_replicas(params, cfg.n_replicas)
    inner_opt = broadcast_to_replicas(optimizer.init(params), cfg.n_replicas)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return HWAState(inner=inner, inner_opt=inner_opt,
                    window_state=window_init(params, cfg.window,
                                             cfg.window_kind,
                                             ring_dtype=ring_dtype),
                    wa=params, cycle=zero, step=zero.clone())


def _replica(tree: PyTree, k: int) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x[k] for x in leaves])


def hwa_inner_step(cfg: HWAConfig, state: HWAState, batches: PyTree,
                   loss_fn: Callable, optimizer: Optimizer, lr
                   ) -> tuple[HWAState, dict]:
    """One optimizer step per replica (Algorithm 1 lines 5-7). ``batches``
    leaves have a leading K axis. Replica k's parameters and optimizer
    state are updated in place in ``state.inner[k]``/``inner_opt[k]``."""
    with trace.span("hwa.step"):
        losses, metric_rows = [], []
        for k in range(cfg.n_replicas):
            leaves, treedef = tree_flatten(state.inner)
            live = [x[k].detach().requires_grad_(True) for x in leaves]
            params = tree_unflatten(treedef, live)
            with trace.span("hwa.step.forward", k=k):
                loss, metrics = loss_fn(params, _replica(batches, k))
            # a leaf the loss does not use (BN running state carried in
            # the averaged tree) gets a zero gradient, as in JAX
            with trace.span("hwa.step.backward", k=k):
                grads = torch.autograd.grad(loss, live, allow_unused=True,
                                            materialize_grads=True)
            with torch.no_grad(), trace.span("hwa.step.update", k=k):
                opt_k = _replica(state.inner_opt, k)
                plain = tree_unflatten(treedef, [x.detach() for x in live])
                updates, opt2 = optimizer.update(
                    tree_unflatten(treedef, list(grads)), opt_k, plain, lr)
                for dst, src in zip(leaves, tree_leaves(
                        apply_updates(plain, updates))):
                    dst[k].copy_(src)
                for dst, src in zip(tree_leaves(state.inner_opt),
                                    tree_leaves(opt2)):
                    dst[k].copy_(src)
            del grads, live, params
            losses.append(loss.detach())
            metric_rows.append({n: v.detach() for n, v in metrics.items()
                                if torch.is_tensor(v)
                                and v.is_floating_point() and v.ndim <= 1})
        losses = torch.stack(losses)
        scalar = {n: torch.stack([row[n] for row in metric_rows]).mean(0)
                  for n in metric_rows[0]}
        state.step = state.step + 1
        return state, {"loss": losses.mean(), "per_replica_loss": losses,
                       **scalar}


def hwa_local_inner_step(params: PyTree, opt_state: PyTree, batch: PyTree,
                         loss_fn: Callable, optimizer: Optimizer, lr,
                         grad_hook: Callable | None = None
                         ) -> tuple[PyTree, PyTree, torch.Tensor, dict]:
    """One replica's step (Algorithm 1 lines 5-7) with no leading K axis:
    the mesh-native train step of a rank. The same arithmetic as one
    replica of :func:`hwa_inner_step`. It issues no collective across
    replicas: inter-replica traffic happens only in the sync, every H
    steps. ``grad_hook(grads, loss) -> (grads, loss)`` sees the flat
    gradients before the optimizer (a data axis inside the replica takes
    its mean there). The optimizer steps one leaf at a time and writes
    the parameters and its parameter-shaped state in place (ranks may
    share a card: one leaf's temporaries are alive, not the whole
    tree's); an entry of the state shaped otherwise (AdamW's step count)
    is read whole by every leaf's update and replaced once. The
    optimizers are elementwise, so the bits are the whole tree's update's.
    Returns (new params, new optimizer state, loss, metrics)."""
    leaves, treedef = tree_flatten(params)
    live = [x.detach().requires_grad_(True) for x in leaves]
    loss, metrics = loss_fn(tree_unflatten(treedef, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    if grad_hook is not None:
        grads, loss = grad_hook(list(grads), loss)
    with torch.no_grad():
        plain = [x.detach() for x in live]
        flat = {k: tree_flatten(v) for k, v in opt_state.items()}
        per_leaf = {k: f for k, (f, d) in flat.items() if d == treedef}
        whole = {k: v for k, v in opt_state.items() if k not in per_leaf}
        st = whole
        for i, (p, g) in enumerate(zip(plain, grads)):
            u, st = optimizer.update(
                [g], {**whole, **{k: [v[i]] for k, v in per_leaf.items()}},
                [p], lr)
            for k, v in per_leaf.items():
                v[i].copy_(st[k][0])
            p.copy_(apply_updates([p], u)[0])
    opt_state = {**opt_state, **{k: st[k] for k in whole}}
    return tree_unflatten(treedef, plain), opt_state, loss.detach(), metrics


def window_push_packed(cfg: HWAConfig, new_buf: torch.Tensor,
                       window_state: WindowState, cycle: torch.Tensor
                       ) -> tuple[WindowState, torch.Tensor, torch.Tensor]:
    """Packed-in/packed-out Algorithm-2 tail: push the packed W̄ into the
    slide window unless the cycle misses ``window_stride`` (the sparse
    window, §III-B), with W̿ = W̄ until the first entry exists. Returns
    (window state, packed W̿_e, incremented cycle counter). The update
    takes its kernel when ``cfg.use_kernels``.

    With a stride > 1 the cycle counter is read back to the host once per
    call (``int(cycle)``): the reference decides on the device with a
    ``lax.cond``, which PyTorch has no counterpart of, and computing both
    branches over P and selecting would double the sync's traffic. A
    skipped cycle leaves the window as it is and returns its average."""
    if cfg.window_stride == 1 or int(cycle) % cfg.window_stride == 0:
        new_ws, avg = window_update_packed(window_state, new_buf,
                                           use_kernel=cfg.use_kernels)
    else:
        new_ws, avg = window_state, window_average_packed(window_state)
    avg = torch.where(new_ws.count == 0, new_buf, avg)
    return new_ws, avg, cycle + 1


def _window_push(cfg: HWAConfig, outer: PyTree, window_state: WindowState,
                 cycle: torch.Tensor):
    """Tree-level wrapper of :func:`window_push_packed`: packs W̄ once,
    unpacks only the final W̿."""
    new_ws, avg, new_cycle = window_push_packed(
        cfg, pack(outer, window_state.spec), window_state, cycle)
    return new_ws, unpack(avg, window_state.spec, like=outer), new_cycle


def _sync_fused(cfg: HWAConfig, state: HWAState):
    """Whole sync in ONE kernel launch over packed state: the K replicas
    packed into (K, P), then the K-mean and the window push in one pass,
    (K+2) reads + 3 writes. W̄ for the restart is read back from the ring
    slot just written; only W̄ and W̿ are unpacked. The window scalars stay
    on the device (no host synchronization).

    A bf16 ring takes the compressed kernel (the reference's
    ``_sync_fused_c``): the slot is written in bf16 and the f32 total
    keeps its Kahan compensation. W̄ is then the DECODED slot, so every
    replica restarts from the bf16-rounded mean that the ring holds."""
    ws = state.window_state
    I = ws.window
    with trace.span("hwa.sync.pack"):
        stacked = pack_stacked(state.inner, ws.spec)
    idx = ws.next_idx
    full_flag, new_count, inv_count = window_scalars(ws)
    comp = ws.comp
    if ws.ring.dtype == torch.bfloat16:
        ring, total, comp, avg = wa_update.wa_sync_fused_c(
            stacked, ws.ring, ws.total, comp, idx, full_flag, inv_count)
    else:
        ring, total, avg = wa_update.wa_sync_fused(
            stacked, ws.ring, ws.total, idx, full_flag, inv_count)
    del stacked
    new_ws = WindowState(ring=ring, total=total, count=new_count,
                         next_idx=torch.remainder(idx + 1, I)
                         .to(torch.int32),
                         window=I, kind=ws.kind, spec=ws.spec, comp=comp,
                         scales=ws.scales)
    with trace.span("hwa.sync.restart"):
        # the slot just written IS W̄_e (a device-side gather: no host
        # read)
        outer = unpack(ring.index_select(0, idx.reshape(1).long())[0],
                       ws.spec)
        wa = unpack(avg, ws.spec)
    return outer, new_ws, wa, state.cycle + 1


def hwa_sync(cfg: HWAConfig, state: HWAState) -> tuple[HWAState, dict]:
    """End-of-cycle sync (Algorithm 1 lines 8-12 + Algorithm 2).

    The route is the reference's. With ``use_kernels``, an f32 or bf16
    ring at stride 1 syncs in ONE launch (:func:`_sync_fused`). Any
    other window (a stride >
    1, the streaming window, an fp8 ring) takes two packed steps: the
    ``online_mean`` kernel, then the window push, whose update is a
    kernel for an f32 or bf16 ring and plain otherwise. Without
    ``use_kernels``: the plain mean (sum/K) and the plain window push.
    The replicas restart from W̄ in place. Returns (state, metrics).

    With ``cfg.resilient`` the mean is the alive-masked one
    (``resilience.health``), taken before anything is written in place:
    a NaN'd or diverged replica is left out of W̄, restarts from W̄ like
    the others, and has its optimizer slots zeroed in place (or, with
    ``avg_opt_state``, gets the alive-masked mean of the slots). The
    sync kernels cannot mask, so the mean is plain; the window push
    still takes the window-update kernel with ``use_kernels`` (an f32 or
    bf16 ring). With every replica alive it is bit-equal to the plain
    route. The alive count is the ``k_alive`` metric (int32)."""
    with trace.span("hwa.sync"):
        with trace.span("hwa.sync.divergence"):
            div = replica_divergence(state.inner)
        ws = state.window_state
        alive = None
        if cfg.resilient:
            alive = replica_alive_mask(state.inner,
                                       max_rms=cfg.max_param_rms)
            outer = masked_mean_axis0(state.inner, alive)
            window_state, wa, cycle = _window_push(cfg, outer, ws,
                                                   state.cycle)
        elif (cfg.use_kernels and ws.kind == "ring"
                and cfg.window_stride == 1
                and ws.ring.dtype in wa_update.KERNEL_RING_DTYPES):
            outer, window_state, wa, cycle = _sync_fused(cfg, state)
        elif cfg.use_kernels and tree_leaves(state.inner):
            # two packed launches, no unpack and re-pack of W̄ between them
            buf = wa_update.online_mean(pack_stacked(state.inner, ws.spec))
            outer = unpack(buf, ws.spec)
            window_state, avg, cycle = window_push_packed(cfg, buf, ws,
                                                          state.cycle)
            wa = unpack(avg, ws.spec)
        else:
            outer = online_average(state.inner)
            window_state, wa, cycle = _window_push(cfg, outer, ws,
                                                   state.cycle)
        with trace.span("hwa.sync.restart"):
            restart_replicas(state.inner, outer)
            if cfg.avg_opt_state:
                opt_mean = (tree_mean_axis0(state.inner_opt)
                            if alive is None
                            else masked_mean_axis0(state.inner_opt, alive))
                restart_replicas(state.inner_opt, opt_mean)
            elif alive is not None:
                quarantine_opt_state(state.inner_opt, alive)
        new_state = HWAState(inner=state.inner, inner_opt=state.inner_opt,
                             window_state=window_state, wa=wa, cycle=cycle,
                             step=state.step)
        metrics = {"replica_divergence": div, "cycle": cycle}
        if alive is not None:
            metrics["k_alive"] = alive.sum(dtype=torch.int32)
        return new_state, metrics
