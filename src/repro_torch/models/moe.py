"""Mixture-of-Experts layer (qwen2-moe / granite-moe style).

Counterpart of ``repro.models.moe``, with its parameter tree and leaf
names (``router`` (D, E) f32, ``w_gate``/``w_up`` (E, D, F) and
``w_down`` (E, F, D) in the model dtype; with shared experts ``sh_gate``,
``sh_up``, ``sh_down`` and the f32 sigmoid gate ``sh_route`` (D, 1)),
stacked along a leading layer axis as every leaf of the port's stack.

Tokens are routed with a stable sort and the expert products run over
the sorted groups, with no capacity drops (:func:`moe_forward`). The
grouped product is picked once per device: on a CUDA tensor one
``torch._grouped_mm`` per weight with the group ends on the device (no
host sync); on the CPU a loop of ``torch.matmul`` over the groups, the
plain version the tests hold against ``jax.lax.ragged_dot``.

While a profiler runs, the dispatch and the combine are the
``common.trace`` spans ``moe.dispatch`` and ``moe.combine``, and each
call adds its largest and mean group to the counter
``moe.expert_pairs``.

Both the dispatch and the combine are free of atomics, so a step gives
the same bits on every run: each token's row reaches its k pairs through
an ``expand`` and a permutation (whose backward is a sum over k and a
scatter without collisions, not an accumulating index), and each
token's k expert outputs are added in ascending expert order onto +0,
as the reference's scatter-add meets them.

The capacity dispatch (:func:`moe_forward_capacity`) is the reference's
single-device at-scale variant. :func:`moe_forward_sharded` is the layer
with a model axis inside a replica (``models.parallel``): the experts'
hidden dim split over the model ranks, their outputs summed over them.
:func:`moe_forward_ep` is the reference's expert-parallel all-to-all
layer: the experts split over the model ranks, the tokens exchanged to
them and back with the capacity dispatch (``launch.mesh.ReplicaMesh
.all_to_all``). It runs where the rules split the experts: a train step
built with ``expert_parallel`` (``launch.sync.bundles.replica_layout``)
on a config with ``expert_parallel=True``. ``cfg.expert_parallel``
selects nothing where no such rules apply, as in the reference (which
ignores it wherever ``rules is None``, its whole mesh-native path
included): ``--mesh-native`` runs the plain layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import trace
from repro_torch.models.common import activation, normal_init

def init_moe(cfg, n: int, gen: torch.Generator, dtype, device):
    """``n`` stacked layers of the reference's ``init_moe`` tree, each
    leaf drawn a layer at a time (``normal_init``)."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.expert_d_ff or cfg.d_ff

    def draw(shape, dt, fan_in):
        return normal_init(gen, (n, *shape), dt, fan_in=fan_in, device=device)

    p = {"router": draw((D, E), torch.float32, D),
         "w_gate": draw((E, D, Fe), dtype, D),
         "w_up": draw((E, D, Fe), dtype, D),
         "w_down": draw((E, Fe, D), dtype, Fe)}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        p["sh_gate"] = draw((D, Fs), dtype, D)
        p["sh_up"] = draw((D, Fs), dtype, D)
        p["sh_down"] = draw((Fs, D), dtype, Fs)
        p["sh_route"] = draw((D, 1), torch.float32, D)
    return p


def moe_dims(cfg) -> dict:
    """Logical dims of one MoE layer's leaves (``sharding.rules``)."""
    d = {"router": ("embed", "experts"),
         "w_gate": ("experts", "embed", "mlp"),
         "w_up": ("experts", "embed", "mlp"),
         "w_down": ("experts", "mlp", "embed")}
    if cfg.n_shared_experts:
        d.update(sh_gate=("embed", "mlp"), sh_up=("embed", "mlp"),
                 sh_down=("mlp", "embed"), sh_route=("embed", None))
    return d


def _route(cfg, p, xf):
    """Top-k routing in f32. xf: (N, D) -> probs (N, k), ids (N, k), the
    Switch load-balance loss E * sum_e f_e * P_e."""
    logits = xf.float() @ p["router"]                           # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)                 # renormalize
    E = cfg.n_experts
    occupancy = torch.zeros(E, dtype=torch.float32, device=xf.device) \
        .scatter_add_(0, top_i.reshape(-1),
                      torch.ones(top_i.numel(), device=xf.device))
    f = occupancy / (xf.shape[0] * cfg.top_k)
    P = probs.mean(0)
    return top_p, top_i, E * torch.sum(f * P)


def _grouped_mm_loop(x, w, counts):
    """The plain grouped product: x (M, K) sorted by group, w (G, K, N),
    ``counts`` the G group sizes on the host. Split and unbind (not
    slicing and indexing) keep the backward to one concatenation and one
    stack."""
    outs = [xe @ we for xe, we in zip(torch.split(x, counts), w.unbind(0))]
    return torch.cat(outs)


def ffn_impl(device) -> str:
    """The grouped product a device runs: ``"device"`` on a CUDA device,
    ``"loop"`` elsewhere."""
    return "device" if torch.device(device).type == "cuda" else "loop"


def expert_ffn(cfg, p, tokens, counts, impl: str | None = None):
    """SwiGLU experts over ``tokens`` (M, D) sorted by expert; ``counts``
    (E,) int64 group sizes on the device. ``impl`` overrides
    :func:`ffn_impl` (chip_smoke times both on the card)."""
    impl = impl or ffn_impl(tokens.device)
    if impl == "device":
        ends = torch.cumsum(counts, 0).to(torch.int32)  # bf16 on sm90

        def mm(a, w):
            return torch._grouped_mm(a, w, offs=ends)
    elif impl == "loop":
        sizes = counts.tolist()

        def mm(a, w):
            return _grouped_mm_loop(a, w, sizes)
    else:
        raise ValueError(f"unknown grouped product {impl!r}")
    act = activation(cfg.act)
    g, u = mm(tokens, p["w_gate"]), mm(tokens, p["w_up"])
    h = (act(g.float()) * u.float()).to(tokens.dtype)
    return mm(h, p["w_down"])


def _shared(cfg, p, xf, par=None):
    """The shared experts' output, gated by the f32 sigmoid router. With
    a model axis their hidden dim is split (column then row) and the
    output summed over ``model`` before the gate, which reads the whole
    input on every rank."""
    act = activation(cfg.act)
    split = par is not None and par.splits(
        cfg.n_shared_experts * (cfg.expert_d_ff or cfg.d_ff))
    xm = par.copy_to_model(xf) if split else xf
    h = (act((xm @ p["sh_gate"]).float())
         * (xm @ p["sh_up"]).float()).to(xf.dtype)
    shared = h @ p["sh_down"]
    if split:
        shared = par.reduce_from_model(shared)
    return torch.sigmoid(xf.float() @ p["sh_route"]) * shared.float()


def _combine(pairs):
    """(N, k, D) f32 -> (N, D): the k outputs added in order onto +0."""
    out = torch.zeros_like(pairs[:, 0])
    for j in range(pairs.shape[1]):
        out = out + pairs[:, j]
    return out


def _moe(cfg, p, x, impl, par):
    B, S, D = x.shape
    N, k = B * S, cfg.top_k
    xf = x.reshape(N, D)
    split = par is not None and par.splits(cfg.expert_d_ff or cfg.d_ff)
    with trace.span("moe.dispatch"):
        top_p, top_i, aux = _route(cfg, p, xf)
        # each token's pairs in ascending expert order: the stable sort
        # then lists a group's pairs by token, as the reference's sort
        # does, and a token's pairs reach the combine in the order its
        # scatter adds them
        e_sorted, j = top_i.sort(dim=1)
        w_sorted = top_p.gather(1, j).reshape(-1)
        flat_e = e_sorted.reshape(-1)                           # (N*k,)
        order = torch.argsort(flat_e, stable=True)
        xm = par.copy_to_model(xf) if split else xf
        pairs = xm[:, None].expand(N, k, D).reshape(N * k, D)
        counts = torch.zeros(cfg.n_experts, dtype=torch.int64,
                             device=x.device) \
            .scatter_add_(0, flat_e, torch.ones_like(flat_e))
        sorted_pairs = pairs[order]
    # the largest and the mean group, summed over the layer calls
    trace.count("moe.expert_pairs", lambda: torch.stack(
        (counts.max().float(), counts.float().mean())))
    out_sorted = expert_ffn(cfg, p, sorted_pairs, counts, impl)
    if split:
        # each rank's experts hold a block of the hidden dim: the pairs'
        # outputs are partial sums, summed over ``model`` before the
        # routing weights (which every rank holds whole) scale them
        out_sorted = par.reduce_from_model(out_sorted)
    with trace.span("moe.combine"):
        out_sorted = out_sorted * w_sorted[order][:, None].to(
            out_sorted.dtype)
        inverse = torch.empty_like(order).scatter_(
            0, order, torch.arange(N * k, device=x.device))
        out = _combine(out_sorted.float()[inverse].reshape(N, k, D))
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, xf, par)
    return out.reshape(B, S, D).to(x.dtype), aux


def moe_forward(cfg, p, x, impl: str | None = None):
    """x: (B, S, D) -> (out, aux_loss). The sort-based dispatch with no
    capacity drops."""
    return _moe(cfg, p, x, impl, None)


def _capacity_ffn(cfg, p, xf, top_p, top_i, capacity_factor=1.25):
    """Capacity-based dispatch: an (E, C, D) buffer and batched products.
    Pairs beyond an expert's capacity C = N*k*cf/E are dropped
    (Switch/GShard semantics)."""
    N, D = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    C = max(int(N * k * capacity_factor) // E, 8)
    flat_e = top_i.reshape(-1)
    onehot = F.one_hot(flat_e, E)
    rank = (torch.cumsum(onehot, 0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = rank < C
    safe_rank = torch.where(keep, rank, torch.zeros_like(rank))
    pairs = xf[:, None].expand(N, k, D).reshape(N * k, D)
    # dropped pairs add exact zeros onto a kept pair's row, as in JAX
    buf = xf.new_zeros((E, C, D)).index_put(
        (flat_e, safe_rank),
        torch.where(keep[:, None], pairs, torch.zeros_like(pairs)),
        accumulate=True)
    act = activation(cfg.act)
    g, u = torch.bmm(buf, p["w_gate"]), torch.bmm(buf, p["w_up"])
    h = (act(g.float()) * u.float()).to(buf.dtype)
    y = torch.bmm(h, p["w_down"])
    out_pairs = y[flat_e, safe_rank]
    out_pairs = torch.where(keep[:, None], out_pairs,
                            torch.zeros_like(out_pairs))
    out_pairs = out_pairs * top_p.reshape(-1)[:, None].to(out_pairs.dtype)
    return _combine(out_pairs.float().reshape(N, k, D))


def moe_forward_capacity(cfg, p, x, capacity_factor=1.25):
    """:func:`moe_forward` with the capacity dispatch."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    top_p, top_i, aux = _route(cfg, p, xf)
    out = _capacity_ffn(cfg, p, xf, top_p, top_i, capacity_factor)
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, xf)
    return out.reshape(B, S, D).to(x.dtype), aux


def moe_forward_sharded(cfg, p, x, par):
    """The layer with a model axis inside the replica (``models.parallel``
    ``Par``), the reference's ``moe_forward_sharded`` semantics: the
    experts' hidden dim (``mlp``) split over the model ranks, their
    output summed over ``model``, the router and its loss whole on every
    rank. The dispatch is :func:`moe_forward`'s, with no capacity drops:
    the reference's mesh-native step runs its model without sharding
    rules, so its layer is the plain one. The router loss of a data rank
    covers its rows; the train step's data mean (``Par.data_mean``) makes
    it the mean over ``data``, the reference's ``pmean``."""
    return _moe(cfg, p, x, None, par)


#: the expert-parallel layer's (token, k) pairs and dropped pairs in this
#: process since :func:`ep_tally` last reset them: device tensors, so the
#: layer reads nothing back to the host
EP_TALLY: dict = {}


def ep_tally(reset: bool = False) -> dict:
    """``{"pairs": n, "dropped": n}`` the expert-parallel layer dispatched
    in this process (each forward counts, the recomputed one under remat
    too), read to the host; ``reset`` zeroes them."""
    out = {k: int(v) for k, v in EP_TALLY.items()}
    if reset:
        EP_TALLY.clear()
    return out


class _Exchange(torch.autograd.Function):
    """``ReplicaMesh.all_to_all`` over the model ranks: ``x`` (tp, ...)
    block i to model rank i, block i of the result from model rank i.
    The exchange is its own transpose, so the backward is the same
    exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_to_all(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g.contiguous(), ctx.axes), None, None


def _ep_dispatch(cfg, p, xf, top_p, top_i, capacity_factor, par):
    """The reference's ``local_fn`` on one rank's tokens ``xf`` (N, D),
    routed: the (E, C, D) capacity buffer, the exchange to the experts'
    ranks, the rank's E/tp experts, the exchange back and the combine.
    Returns (N, D) f32."""
    N, D = xf.shape
    E, k, tp = cfg.n_experts, cfg.top_k, par.tp
    El = E // tp
    C = max(int(N * k * capacity_factor) // E, 8)
    flat_e = top_i.reshape(-1)                                  # pair order
    # each pair's rank within its expert, from a running count in pair
    # order: pairs past the capacity C are dropped
    rank = (torch.cumsum(F.one_hot(flat_e, E), 0) - 1).gather(
        1, flat_e[:, None])[:, 0]
    keep = rank < C
    # the buffer with one trash slot an expert (slot C): a kept pair owns
    # its slot, the dropped pairs land in the trash, which is cut off, so
    # no slot is written twice and nothing accumulates
    slot = flat_e * (C + 1) + torch.where(keep, rank,
                                          torch.full_like(rank, C))
    pairs = xf[:, None].expand(N, k, D).reshape(N * k, D)
    buf = xf.new_zeros((E * (C + 1), D)).index_copy(0, slot, pairs)
    buf = buf.view(E, C + 1, D)[:, :C]
    # the tiled all-to-all (split 0, concat 1): (E, C, D) -> (E/tp, tp*C,
    # D), the rank's experts over every model rank's tokens
    recv = _Exchange.apply(buf.reshape(tp, El, C, D).contiguous(),
                           par.mesh, par.model_axes)
    tokens = recv.transpose(0, 1).reshape(El, tp * C, D)
    act = activation(cfg.act)
    # gate and up accumulate in f32 (the reference's preferred f32), h
    # and down in the buffer's dtype
    g = torch.bmm(tokens.float(), p["w_gate"].float())
    u = torch.bmm(tokens.float(), p["w_up"].float())
    h = (act(g) * u).to(tokens.dtype)
    y = torch.bmm(h, p["w_down"])
    # the reverse exchange: (E/tp, tp*C, D) -> (E, C, D)
    back = _Exchange.apply(y.reshape(El, tp, C, D).transpose(0, 1)
                           .contiguous(), par.mesh, par.model_axes)
    y = torch.cat([back.reshape(E, C, D), back.new_zeros((E, 1, D))], 1)
    # a kept pair reads its slot, a dropped one the zero trash slot
    out_pairs = y.reshape(E * (C + 1), D).index_select(0, slot)
    out_pairs = out_pairs * top_p.reshape(-1)[:, None].to(out_pairs.dtype)
    return _combine(out_pairs.float().reshape(N, k, D)), keep


def moe_forward_ep(cfg, p, x, par, capacity_factor: float | None = None,
                   with_keep: bool = False):
    """The expert-parallel layer (the reference's ``moe_forward_ep``) on
    one rank of a replica split over ``model`` (``models.parallel.Par``
    with ``expert_parallel``): the rank holds E/tp experts, a contiguous
    block (``w_gate``/``w_up``/``w_down`` split on ``experts``), the
    router and the shared experts gathered whole (``Par.gather_leaves``).

    The tokens: the rank's data rows, and over ``model`` the rank's block
    of the sequence when S divides by tp (taken before the dispatch, the
    outputs all-gathered back after the combine); otherwise every model
    rank dispatches all its rows, as the reference's batch-only split
    does, and the output's gradient is divided by tp (each of the tp
    copies of a token reaches the experts) while the input's is summed
    over ``model``, as the reference's transpose does. On the rank's
    tokens: the f32 routing, the capacity C = max(int(N·k·cf) // E, 8)
    from the rank's N, the exchange (:func:`_ep_dispatch`).

    The shared experts (a repair of the reference, whose EP path drops
    them): their term is added on the rank's tokens as
    ``moe_forward_capacity`` adds it, ``sh_route`` whole with its
    gradient summed over ``model``.

    ``aux`` is the router loss of the rank's tokens; the train step's data
    mean (``Par.data_mean``) makes it the mean over ``data``, the
    reference's ``pmean``. The reference hands back, from its
    ``out_specs=P()``, the value of model shard 0 (checked on the CPU),
    which is the replica's lead rank's here, and its gradient is the mean
    over every shard's: so each rank's ``aux`` carries its gradient
    divided by tp (the router's gradient is summed over ``model``). The
    loss values of the other model ranks differ in that term only and are
    not read. Returns (out (B, S, D), aux), and the pairs' kept mask of
    the rank's tokens with ``with_keep``."""
    from repro_torch.models.parallel import scale_grad
    E, tp = cfg.n_experts, par.tp
    if tp == 1 or E % tp:
        raise ValueError(f"moe_forward_ep splits {E} experts over the "
                         f"model ranks ({tp}): needs E % tp == 0, tp > 1")
    cf = capacity_factor or cfg.moe_capacity_factor
    B, S, D = x.shape
    seq = S % tp == 0
    xr = par.scatter_model(x, 1) if seq else par.copy_to_model(x)
    xf = xr.reshape(-1, D)
    top_p, top_i, aux = _route(cfg, p, xf)
    out, keep = _ep_dispatch(cfg, p, xf, top_p, top_i, cf, par)
    EP_TALLY["pairs"] = EP_TALLY.get("pairs", 0) + keep.numel()
    EP_TALLY["dropped"] = EP_TALLY.get("dropped", 0) + (~keep).sum()
    if cfg.n_shared_experts:
        out = out + _shared(cfg, dict(p, sh_route=par.copy_to_model(
            p["sh_route"])), xf)
    out = out.reshape(xr.shape).to(x.dtype)
    out = par.gather_blocks(out, 1) if seq else scale_grad(out, 1.0 / tp)
    aux = scale_grad(aux, 1.0 / tp)
    return (out, aux, keep) if with_keep else (out, aux)


def ep_cases(mesh, cases) -> list[dict]:
    """Run :func:`moe_forward_ep` on this rank (a ``launch.mesh
    .spawn_ranks`` target over a ``{"data": dp, "model": tp}`` mesh with
    the levels ``("data",)`` and ``("model",)``: the parity tests' and
    ``chip_smoke.py``'s way in). A case is a dict: ``cfg``, ``p`` (one
    layer's whole MoE leaves on the CPU), ``x`` (B, S, D) and ``g`` (the
    cotangent of the output) on the CPU, ``cf`` the capacity factor,
    ``coef`` the router loss's weight, and ``tp_layer`` to run the
    tensor-parallel layer (:func:`moe_forward_sharded`) on the same rows
    too; or ``{"exchange": x}`` to exchange ``x`` (tp, ...) over
    ``model`` both from the CPU and from the rank's device.

    The rank takes its data rows of ``x`` and its blocks of the leaves by
    the expert-parallel rules, gathers the router and the shared experts
    (``Par.gather_leaves``), and differentiates ``sum(out · g) + coef ·
    aux / dp``: over the data ranks that is the reference's ``sum(out ·
    g) + coef · pmean(aux)``. Returns, per case, the rank's output rows,
    ``aux``, the kept mask of its pairs, the gradient of its rows of
    ``x`` and of its blocks of the leaves (summed over ``data``), the
    tensor-parallel layer's output where asked, and the collectives it
    issued, on the CPU."""
    from repro_torch.common.pytree import tree_flatten, tree_map
    from repro_torch.launch.mesh import ledger_delta, ledger_snapshot
    from repro_torch.models.parallel import Par, blocks_of, places_tree
    from repro_torch.sharding.rules import make_tp_rules
    dev = mesh.device
    out = []
    for case in cases:
        if "exchange" in case:
            x = case["exchange"]
            out.append({"cpu": mesh.all_to_all(x.clone(), ("model",)),
                        "device": mesh.all_to_all(x.to(dev), ("model",))
                        .cpu()})
            continue
        cfg = case["cfg"]
        before = ledger_snapshot()

        def blocks(ep):
            rules = make_tp_rules(mesh.shape, expert_parallel=ep)
            whole = case["p"]
            flat, _ = tree_flatten(whole)
            dims = moe_dims(cfg)
            places = places_tree(whole, rules.flat_specs(
                [tuple(v.shape) for v in flat], dims),
                [dims[k] for k in sorted(dims)])
            return places, tree_map(
                lambda v: v.contiguous().clone().to(dev),
                blocks_of(whole, places, mesh))
        places, p = blocks(True)
        par = Par(mesh, cfg, places)
        for v in p.values():
            v.requires_grad_(True)
        rows = case["x"].shape[0] // par.dp
        sl = slice(par.dp_index * rows, (par.dp_index + 1) * rows)
        x = case["x"][sl].to(dev).requires_grad_(True)
        used = par.gather_leaves({"moe": p}, {"moe": places}, {
            "moe": dict.fromkeys(("router", "sh_gate", "sh_up", "sh_down"),
                                 True)})["moe"]
        y, aux, keep = moe_forward_ep(cfg, used, x, par, case["cf"],
                                      with_keep=True)
        loss = (y.float() * case["g"][sl].to(dev)).sum() \
            + case["coef"] * aux / par.dp
        loss.backward()
        grads = {k: v.grad for k, v in p.items()}
        if par.dp > 1:
            grads = {k: mesh.psum(v.contiguous(), ("data",))
                     for k, v in grads.items()}
        rec = {"out": y.detach(), "aux": aux.detach(), "keep": keep,
               "x_grad": x.grad, "grads": grads}
        if case.get("tp_layer"):
            tplaces, tp = blocks(False)
            tpar = Par(mesh, cfg, tplaces)
            with torch.no_grad():
                rec["out_tp"] = moe_forward_sharded(cfg, tp, x.detach(),
                                                    tpar)[0]
        rec = tree_map(lambda v: v.detach().cpu(), rec)
        rec["collectives"] = ledger_delta(before, ledger_snapshot())
        out.append(rec)
    return out
