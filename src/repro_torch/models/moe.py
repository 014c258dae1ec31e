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
``cfg.expert_parallel`` selects nothing where no sharding rules apply,
as in the reference (which ignores it wherever ``rules is None``, its
whole mesh-native path included); the expert-parallel all-to-all path
(:func:`moe_forward_ep`) raises, naming its ROADMAP.md item.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import activation, normal_init

#: what the expert-parallel path waits for
EP_ITEM = ("ROADMAP.md Queue A 17 (the expert-parallel all-to-all MoE; "
           "only the reference's GSPMD builders reach it)")


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
    top_p, top_i, aux = _route(cfg, p, xf)
    # each token's pairs in ascending expert order: the stable sort then
    # lists a group's pairs by token, as the reference's sort does, and
    # a token's pairs reach the combine in the order its scatter adds them
    e_sorted, j = top_i.sort(dim=1)
    w_sorted = top_p.gather(1, j).reshape(-1)
    flat_e = e_sorted.reshape(-1)                               # (N*k,)
    order = torch.argsort(flat_e, stable=True)
    split = par is not None and par.splits(cfg.expert_d_ff or cfg.d_ff)
    xm = par.copy_to_model(xf) if split else xf
    pairs = xm[:, None].expand(N, k, D).reshape(N * k, D)
    counts = torch.zeros(cfg.n_experts, dtype=torch.int64, device=x.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))
    out_sorted = expert_ffn(cfg, p, pairs[order], counts, impl)
    if split:
        # each rank's experts hold a block of the hidden dim: the pairs'
        # outputs are partial sums, summed over ``model`` before the
        # routing weights (which every rank holds whole) scale them
        out_sorted = par.reduce_from_model(out_sorted)
    out_sorted = out_sorted * w_sorted[order][:, None].to(out_sorted.dtype)
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


def moe_forward_ep(cfg, p, x, *, mesh, axis: str = "model",
                   capacity_factor: float | None = None):
    """The reference's expert-parallel all-to-all path: not ported."""
    raise NotImplementedError(f"moe_forward_ep: {EP_ITEM}")
