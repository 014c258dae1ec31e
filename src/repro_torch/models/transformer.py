"""Decoder stack of the LM families: init, the training path, the
whole-batch decode path (contiguous ring cache) and the paged serving
path.

Counterpart of ``repro.models.transformer``. A model is a *pattern* of
sub-layer specs (a "super-block") repeated ``n_layers / len(pattern)``
times; each spec's parameters are stacked along a leading layer axis
(``wq`` (L, D, H, P) and so on), exactly as the JAX package lays them
out, so a bridged parameter tree is a plain copy. Where JAX scans over
the stacked layers, the port runs a Python loop:

  dense / vlm / audio : [attn+mlp]          (window per spec)
  moe     : [attn+moe]                      (models.moe)
  gemma2  : [local attn, global attn] x 23
  xlstm   : [mLSTM block, sLSTM block] x 6  (models.ssm)
  hymba   : [parallel attn || mamba + mlp]  (sliding window)

Sub-layer kinds: "attn" (GQA attention + MLP or MoE), "mlstm" and
"slstm" (xLSTM blocks; sLSTM carries its own FFN), "hybrid" (Hymba's
attention and Mamba heads side by side, fused by softmax(fuse), + MLP).

The decode paths update their caches IN PLACE (``index_copy_``,
``index_put_``, ``copy_``): the contiguous K/V rings and the page pools
and the recurrent states, where the JAX package returns new caches
through donated buffers.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from repro_torch.kernels.head_dim import pad_head_dim, padded_head_dim
from repro_torch.models import ssm
from repro_torch.models.attention import run_attention, select_kv_heads
from repro_torch.models.cache import (TRASH_PAGE, attn_cache_len,
                                      cache_positions, init_attn_cache,
                                      init_paged_pool, paged_phys_pages,
                                      update_attn_cache)
from repro_torch.models.common import (activation, apply_norm, apply_rope,
                                       init_norm, norm_dims, normal_init)
from repro_torch.models.moe import (init_moe, moe_dims, moe_forward,
                                    moe_forward_ep, moe_forward_sharded)
from repro_torch.models.types import ModelConfig


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                    # attn | mlstm | slstm | hybrid
    window: int | None = None    # sliding window (None = full causal)
    use_moe: bool = False


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
        raise NotImplementedError(
            f"family {cfg.family!r} has no LM stack (the port covers the "
            f"dense, MoE, ssm, hybrid, vlm and audio families; convnets "
            f"are models.convnet)")


def block_pattern(cfg: ModelConfig) -> list[LayerSpec]:
    check_family(cfg)
    if cfg.family == "ssm":          # xlstm: alternate mLSTM / sLSTM
        return [LayerSpec("mlstm"), LayerSpec("slstm")]
    if cfg.family == "hybrid":       # hymba: parallel attn+SSM, SWA
        return [LayerSpec("hybrid", window=cfg.sliding_window)]
    if cfg.global_every:             # gemma2: local / global alternation
        return [LayerSpec("attn", window=cfg.sliding_window),
                LayerSpec("attn", window=None)]
    return [LayerSpec("attn", window=cfg.sliding_window,
                      use_moe=cfg.family == "moe")]


# ------------------------------------------------------------------
# per-sub-layer init/apply
# ------------------------------------------------------------------


def _init_attn(cfg, n, gen, dtype, device):
    D = cfg.d_model
    H, K, P = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": normal_init(gen, (n, D, H, P), dtype, fan_in=D, device=device),
        "wk": normal_init(gen, (n, D, K, P), dtype, fan_in=D, device=device),
        "wv": normal_init(gen, (n, D, K, P), dtype, fan_in=D, device=device),
        "wo": normal_init(gen, (n, H, P, D), dtype, fan_in=H * P,
                          device=device),
    }


def _init_mlp(cfg, n, gen, dtype, device):
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": normal_init(gen, (n, D, F), dtype, fan_in=D, device=device),
        "w_up": normal_init(gen, (n, D, F), dtype, fan_in=D, device=device),
        "w_down": normal_init(gen, (n, F, D), dtype, fan_in=F, device=device),
    }


def _stacked_norm(cfg, n, device):
    return {k: v.expand(n, -1).clone()
            for k, v in init_norm(cfg, device=device).items()}


def _init_layer(cfg: ModelConfig, spec: LayerSpec, n: int, gen, dtype,
                device):
    """``n`` stacked copies of one sub-layer's parameters."""
    if spec.kind in ("mlstm", "slstm"):
        init = ssm.init_mlstm if spec.kind == "mlstm" else ssm.init_slstm
        return {"ln1": _stacked_norm(cfg, n, device),
                "cell": init(cfg, n, gen, dtype, device)}
    if spec.kind not in ("attn", "hybrid"):
        raise ValueError(spec.kind)
    params = {"ln1": _stacked_norm(cfg, n, device),
              "ln2": _stacked_norm(cfg, n, device)}
    if cfg.name.startswith("gemma2"):
        params["ln1_post"] = _stacked_norm(cfg, n, device)
        params["ln2_post"] = _stacked_norm(cfg, n, device)
    params["attn"] = _init_attn(cfg, n, gen, dtype, device)
    if spec.kind == "hybrid":
        params["mamba"] = ssm.init_mamba(cfg, n, gen, dtype, device)
        params["fuse"] = torch.ones((n, 2), dtype=torch.float32,
                                    device=device)
    if spec.use_moe:
        params["moe"] = init_moe(cfg, n, gen, dtype, device)
    else:
        params["mlp"] = _init_mlp(cfg, n, gen, dtype, device)
    return params


ATTN_DIMS = {"wq": ("embed", "heads", "head_dim"),
             "wk": ("embed", "kv_heads", "head_dim"),
             "wv": ("embed", "kv_heads", "head_dim"),
             "wo": ("heads", "head_dim", "embed")}
MLP_DIMS = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


def layer_dims(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """Logical dims of one sub-layer's leaves, unstacked: the tree
    :func:`_init_layer` draws, as the reference's ``_init_layer`` names
    them."""
    if spec.kind in ("mlstm", "slstm"):
        cell = ssm.MLSTM_DIMS if spec.kind == "mlstm" else ssm.SLSTM_DIMS
        return {"ln1": norm_dims(cfg), "cell": dict(cell)}
    d = {"ln1": norm_dims(cfg), "ln2": norm_dims(cfg)}
    if cfg.name.startswith("gemma2"):
        d["ln1_post"] = norm_dims(cfg)
        d["ln2_post"] = norm_dims(cfg)
    d["attn"] = dict(ATTN_DIMS)
    if spec.kind == "hybrid":
        d["mamba"] = dict(ssm.MAMBA_DIMS)
        d["fuse"] = (None,)
    if spec.use_moe:
        d["moe"] = moe_dims(cfg)
    else:
        d["mlp"] = dict(MLP_DIMS)
    return d


def _stacked_dims(d):
    if isinstance(d, dict):
        return {k: _stacked_dims(v) for k, v in d.items()}
    return ("layers",) + d


def stack_dims(cfg: ModelConfig) -> list:
    """The stack's dims: one tree per pattern spec, every leaf led by the
    ``layers`` axis."""
    return [_stacked_dims(layer_dims(cfg, spec))
            for spec in block_pattern(cfg)]


def _apply_mlp(cfg, p, x):
    act = activation(cfg.act)
    h = (act((x @ p["w_gate"]).float()) * (x @ p["w_up"]).float()).to(x.dtype)
    return h @ p["w_down"]


def _apply_ffn(cfg, spec: LayerSpec, p, x):
    """The layer's feed-forward half: the MLP, or the MoE layer with its
    router loss (zero for the MLP)."""
    if spec.use_moe:
        return moe_forward(cfg, p["moe"], x)
    return _apply_mlp(cfg, p["mlp"], x), None


def _fuse_hybrid(p, attn_out, m_out):
    """Hymba's fusion of the attention and Mamba heads' outputs: weights
    softmax(fuse), summed in f32, returned in the attention's dtype."""
    w = torch.softmax(p["fuse"], dim=-1)
    return (w[0] * attn_out.float() + w[1] * m_out.float()).to(attn_out.dtype)


_CELLS = {"mlstm": (ssm.mlstm_scan, ssm.init_mlstm_state),
          "slstm": (ssm.slstm_scan, ssm.init_slstm_state)}


def _proj_heads(x, w):
    """x (B,S,D) @ w (D,H,P) -> (B,S,H,P)."""
    D, H, P = w.shape
    return (x @ w.reshape(D, H * P)).reshape(*x.shape[:-1], H, P)


def _attn_call(cfg, p_attn, x, q_pos, k, v, k_pos, window):
    """Project q from x, run attention against provided k/v.

    ``q_pos``: (S,) and ``k_pos``: (T,) global positions (shared over batch).
    """
    q = apply_rope(_proj_heads(x, p_attn["wq"]), q_pos, cfg.rope_theta)
    out = run_attention(cfg.attn_impl, q, k, v, q_pos, k_pos, window=window,
                        logit_softcap=cfg.logit_softcap)
    H, P, D = p_attn["wo"].shape
    return out.reshape(*out.shape[:-2], H * P) @ p_attn["wo"].reshape(H * P, D)


def _project_kv(cfg, p_attn, x, k_pos):
    """K/V projections with RoPE on K. ``k_pos``: (S,) or (B, S)."""
    k = _proj_heads(x, p_attn["wk"])
    v = _proj_heads(x, p_attn["wv"])
    return apply_rope(k, k_pos, cfg.rope_theta), v


# ------------------------------------------------------------------
# the stack
# ------------------------------------------------------------------


def init_stack(cfg: ModelConfig, gen: torch.Generator, dtype, device):
    pattern = block_pattern(cfg)
    n_blocks = cfg.n_layers // len(pattern)
    if n_blocks * len(pattern) != cfg.n_layers:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of the "
                         f"pattern length {len(pattern)}")
    return [_init_layer(cfg, spec, n_blocks, gen, dtype, device)
            for spec in pattern]


def _layer(tree, n):
    """Layer ``n``'s view of a stacked parameter (or cache) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, n) for k, v in tree.items()}
    return tree[n]


def iter_layers(cfg: ModelConfig, stack_params, caches):
    """(spec, layer params, layer cache) in execution order: for each
    super-block, each spec of the pattern. The layer cache holds views of
    the stacked pools and states, so writing into it writes the stack."""
    pattern = block_pattern(cfg)
    n_blocks = cfg.n_layers // len(pattern)
    for n in range(n_blocks):
        for spec, p, c in zip(pattern, stack_params, caches):
            yield spec, _layer(p, n), _layer(c, n)


# ------------------------------------------------------------------
# training path (teacher forcing over the full sequence)
# ------------------------------------------------------------------

def _attn_train_par(cfg, p_attn, h, positions, window, par):
    """Head-parallel attention over the model ranks: the q projection is
    column-parallel over the rank's q heads, k/v over its kv heads (or,
    when the kv heads do not divide and their rule fell through to
    ``head_dim``, over every kv head from the all-gathered leaves, the
    rank keeping the heads its q heads read), ``wo`` row-parallel with a
    sum over ``model``. Where the q heads do not divide either, every
    attention leaf was all-gathered and the attention runs whole on each
    rank."""
    if not par.heads_split:
        k, v = _project_kv(cfg, p_attn, h, positions)
        return _attn_call(cfg, p_attn, h, positions, k, v, positions,
                          window)
    hm = par.copy_to_model(h)
    k, v = _project_kv(cfg, p_attn, hm, positions)
    q = apply_rope(_proj_heads(hm, p_attn["wq"]), positions, cfg.rope_theta)
    n_q = q.shape[2]
    if not par.splits(cfg.n_kv_heads):
        k, v = select_kv_heads(k, v, par.tp_index * n_q, n_q, cfg.n_heads)
    out = run_attention(cfg.attn_impl, q, k, v, positions, positions,
                        window=window, logit_softcap=cfg.logit_softcap)
    H, P, D = p_attn["wo"].shape
    part = out.reshape(*out.shape[:-2], H * P) @ p_attn["wo"].reshape(H * P,
                                                                      D)
    return par.reduce_from_model(part)


def _apply_mlp_par(cfg, p, x, par):
    """The MLP column-then-row over the model ranks (the ``mlp`` dim
    split), its output summed over ``model``; whole on each rank where
    the dim does not divide."""
    if not par.splits(cfg.d_ff):
        return _apply_mlp(cfg, p, x)
    return par.reduce_from_model(_apply_mlp(cfg, p, par.copy_to_model(x)))


def _apply_layer_train_par(cfg, spec: LayerSpec, p, x, positions, par):
    """A layer with a model axis inside the replica (the layer's leaves
    already prepared and gathered, :func:`model_gathers`). The recurrent
    blocks: ``ssm.mlstm_train_par``/``slstm_train_par``. The attention
    layers: :func:`_attn_train_par` (beside ``ssm.mamba_train_par``,
    fused, in Hymba's), then :func:`_apply_mlp_par`, or the MoE layer:
    ``moe.moe_forward_ep`` where the rules split the experts
    (``par.expert_parallel``), ``moe.moe_forward_sharded`` elsewhere."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind in ("mlstm", "slstm"):
        cell = (ssm.mlstm_train_par if spec.kind == "mlstm"
                else ssm.slstm_train_par)
        return x + cell(cfg, p["cell"], apply_norm(cfg, p["ln1"], x),
                        par), zero
    h = apply_norm(cfg, p["ln1"], x)
    attn_out = _attn_train_par(cfg, p["attn"], h, positions, spec.window,
                               par)
    if spec.kind == "hybrid":
        attn_out = _fuse_hybrid(p, attn_out, ssm.mamba_train_par(
            cfg, p["mamba"], h, par))
    if "ln1_post" in p:
        attn_out = apply_norm(cfg, p["ln1_post"], attn_out)
    x = x + attn_out
    h = apply_norm(cfg, p["ln2"], x)
    if spec.use_moe and par.expert_parallel:
        mlp_out, aux = moe_forward_ep(cfg, p["moe"], h, par)
    elif spec.use_moe:
        mlp_out, aux = moe_forward_sharded(cfg, p["moe"], h, par)
    else:
        mlp_out, aux = _apply_mlp_par(cfg, p["mlp"], h, par), zero
    if "ln2_post" in p:
        mlp_out = apply_norm(cfg, p["ln2_post"], mlp_out)
    return x + mlp_out, aux


def apply_layer_train(cfg, spec: LayerSpec, p, x, positions, par=None):
    """Full-sequence layer application. Returns (x, aux) — aux is the MoE
    router loss, zero for the other families. With a ``par``
    (``models.parallel``) and a model axis, every layer runs
    :func:`_apply_layer_train_par`."""
    if par is not None and par.tp > 1:
        return _apply_layer_train_par(cfg, spec, p, x, positions, par)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind in ("mlstm", "slstm"):
        scan, init_state = _CELLS[spec.kind]
        y, _ = scan(cfg, p["cell"], apply_norm(cfg, p["ln1"], x),
                    init_state(cfg, x.shape[0], x.dtype, x.device))
        return x + y, zero
    h = apply_norm(cfg, p["ln1"], x)
    k, v = _project_kv(cfg, p["attn"], h, positions)
    attn_out = _attn_call(cfg, p["attn"], h, positions, k, v, positions,
                          spec.window)
    if spec.kind == "hybrid":
        m_out, _ = ssm.mamba_scan(
            cfg, p["mamba"], h,
            ssm.init_mamba_state(cfg, x.shape[0], x.dtype, x.device))
        attn_out = _fuse_hybrid(p, attn_out, m_out)
    if "ln1_post" in p:
        attn_out = apply_norm(cfg, p["ln1_post"], attn_out)
    x = x + attn_out
    mlp_out, aux = _apply_ffn(cfg, spec, p, apply_norm(cfg, p["ln2"], x))
    if aux is None:
        aux = zero
    if "ln2_post" in p:
        mlp_out = apply_norm(cfg, p["ln2_post"], mlp_out)
    return x + mlp_out, aux


#: the products ``remat="dots"`` keeps: what ``jax.lax.dot_general``
#: becomes in aten (``matmul`` and ``einsum`` decompose into these)
_DOT_OPS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
    torch.ops.aten.mv.default, torch.ops.aten.dot.default})


def _dots_policy(ctx, op, *args, **kwargs):
    """Save every product's output, recompute everything else, as
    ``checkpoint_policies.checkpoint_dots`` does. Ops met with grad mode
    off run inside a custom ``autograd.Function``'s forward (the flash
    kernels' and ``FlashJnp``'s): the reference's ``custom_vjp`` is
    recomputed as a whole under ``jax.checkpoint``, so their products
    are recomputed too rather than held."""
    if op in _DOT_OPS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _maybe_remat(cfg: ModelConfig, fn, rerun_all: bool = False):
    """``remat="full"``: the block's activations are recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant, so parameters
    captured by the block still get their gradients), as
    ``jax.checkpoint`` does; ``"dots"``: the same with the products'
    outputs kept (:func:`_dots_policy`); ``"none"``: kept.

    Under either remat the backward runs the block's forward again: the
    flash kernels sit behind an ``autograd.Function`` that reaches them
    through ``ctypes``, which selective checkpointing cannot see or
    save, so ``"dots"`` re-launches the flash forward once per layer in
    the backward, as ``"full"`` does (the backward sweeps launch once
    each either way). Saved or recomputed, a product gives the same
    bits, so ``"dots"`` and ``"full"`` give the same loss and gradients
    to the bit. ``rerun_all`` runs the whole forward again, not only as
    far as the last tensor the backward needs (no early stop): a model
    axis's sums in the block then run exactly twice a step."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    kw = {"context_fn": _dots_context} if cfg.remat == "dots" else {}

    def remat(x, layer_params):
        if not torch.is_grad_enabled():
            return fn(x, layer_params)
        with set_checkpoint_early_stop(not rerun_all):
            return checkpoint(fn, x, layer_params, use_reentrant=False,
                              **kw)
    return remat


def apply_stack_train(cfg: ModelConfig, stack_params, x, positions,
                      par=None):
    """x: (B, S, D) -> (y, aux_loss_sum). Runs the super-blocks in order
    (the reference scans them), each under :func:`_maybe_remat`. With a
    ``par`` the rank's blocks of each layer's leaves are
    prepared (:meth:`Par.prepare`: FSDP's all-gathers) just before the
    layer."""
    pattern = block_pattern(cfg)
    n_blocks = cfg.n_layers // len(pattern)

    def block(x, layer_params):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for spec, p in zip(pattern, layer_params):
            x, a = apply_layer_train(cfg, spec, p, x, positions, par)
            aux = aux + a
        return x, aux

    block = _maybe_remat(cfg, block,
                         rerun_all=par is not None and par.tp > 1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    places = (None if par is None else
              [_unstack_places(pl) for pl in par.places["stack"]])
    gathers = (None if par is None else
               [model_gathers(cfg, spec, par) for spec in pattern])
    for n in range(n_blocks):
        layer = [_layer(p, n) for p in stack_params]
        if par is not None:
            layer = [par.gather_leaves(par.prepare(lp, pl), pl, g)
                     for lp, pl, g in zip(layer, places, gathers)]
        x, a = block(x, layer)
        aux = aux + a
    return x, aux


def model_gathers(cfg, spec: LayerSpec, par) -> dict:
    """The leaves of a layer all-gathered over ``model`` before it runs
    (``Par.gather_leaves``: sub-tree -> {leaf: partial}): the recurrent
    cells' (``ssm.cell_gathers``) and, in the expert-parallel MoE layer,
    the router and the shared experts, which every rank applies whole to
    its own tokens (their gradients summed over ``model``)."""
    if par.tp == 1:
        return {}
    if spec.use_moe and par.expert_parallel:
        return {"moe": dict.fromkeys(("router", "sh_gate", "sh_up",
                                      "sh_down"), True)}
    return ssm.cell_gathers(cfg, spec.kind, par)


def _unstack_places(tree):
    if isinstance(tree, dict):
        return {k: _unstack_places(v) for k, v in tree.items()}
    return tree.unstacked()


# ------------------------------------------------------------------
# paged decode path (serving tier)
# ------------------------------------------------------------------
#
# K/V lives in a shared page pool addressed through per-sequence block
# tables, positions are PER-SEQUENCE (pos_b: (B,)) so ragged continuous
# batches decode in one fixed-shape step, and attention runs the paged
# kernel (repro_torch.kernels.paged_attention). Recurrent layers (mamba,
# mLSTM, sLSTM) keep constant-size per-slot states beside the pools.


def _paged_impl(cfg) -> str:
    return "kernel" if cfg.attn_impl == "flash_pallas" else "ref"


def _paged_attn(cfg, q, pages, tables, lens, window):
    from repro_torch.kernels.paged_attention import paged_attention
    return paged_attention(q, pages["k"], pages["v"], tables, lens,
                           window=window, logit_softcap=cfg.logit_softcap,
                           sm_scale=cfg.resolved_head_dim ** -0.5,
                           impl=_paged_impl(cfg))


def paged_pool_head_dim(cfg: ModelConfig, device) -> int:
    """The head_dim a page pool is allocated at: where the paged kernel
    runs (a CUDA device, ``attn_impl="flash_pallas"``) the kernel's
    instance (``kernels.head_dim``: the pool is padded once, here, and
    each step's K/V write pads only the new token), elsewhere the true
    one."""
    D = cfg.resolved_head_dim
    if device is None or torch.device(device).type != "cuda" or \
            _paged_impl(cfg) != "kernel":
        return D
    return padded_head_dim(D)


def _pool_write(pool, idx, x):
    """``pool[idx] = x`` in place, ``x`` zero-padded to the pool's
    head_dim."""
    pool.index_put_(idx, pad_head_dim(x, pool.shape[-1]))


def init_stack_paged_cache(cfg: ModelConfig, max_batch, n_pages, page_size,
                           dtype, device):
    """Per-spec serving caches: attention layers get a page pool (the
    physical page index space is shared across specs — one block-table
    entry is valid in every layer's pool), at :func:`paged_pool_head_dim`;
    recurrent layers keep stacked constant-size per-slot states
    (``"mamba"`` beside a hybrid layer's pool, ``"cell"`` for mLSTM and
    sLSTM), f32 but for the conv window in ``dtype``."""
    pattern = block_pattern(cfg)
    n_blocks = cfg.n_layers // len(pattern)

    def stacked(state):
        return {k: v.expand(n_blocks, *v.shape).clone()
                for k, v in state.items()}

    caches = []
    for spec in pattern:
        c = {}
        if spec.kind in ("attn", "hybrid"):
            c["pages"] = init_paged_pool(n_blocks, n_pages, page_size,
                                         cfg.n_kv_heads,
                                         paged_pool_head_dim(cfg, device),
                                         dtype, device=device)
        if spec.kind == "hybrid":
            c["mamba"] = stacked(ssm.init_mamba_state(cfg, max_batch, dtype,
                                                      device))
        if spec.kind in _CELLS:
            c["cell"] = stacked(_CELLS[spec.kind][1](cfg, max_batch, dtype,
                                                     device))
        caches.append(c)
    return caches


def reset_paged_states(caches, reset_mask):
    """Zero the recurrent per-slot states where ``reset_mask`` (B,) is set
    (in place; run at admission so a reused batch slot starts clean). As
    the reference, this multiplies by ``1 - mask`` rather than filling, so
    a non-finite state stays non-finite. Page pools need no reset: stale
    pages are hidden by the lens masking."""
    for c in caches:
        for key in ("mamba", "cell"):
            for s in c.get(key, {}).values():
                keep = 1.0 - reset_mask.to(s.dtype)
                s.mul_(keep.reshape((1, -1) + (1,) * (s.ndim - 2)))
    return caches


def _store_state(dst, new, slot=None):
    """Write a scan's state into the layer cache's views, in place (at
    batch row ``slot`` when given: the prefill scans one slot)."""
    for k, v in new.items():
        d = dst[k] if slot is None else dst[k][slot]
        d.copy_(v if slot is None else v[0])


def _cell_step(cfg, spec, p, cache, x):
    """An mLSTM or sLSTM block over x from the layer cache's state, which
    it replaces in place. Returns x."""
    y, new = _CELLS[spec.kind][0](cfg, p["cell"],
                                  apply_norm(cfg, p["ln1"], x),
                                  cache["cell"])
    _store_state(cache["cell"], new)
    return x + y


def _attn_ffn_tail(cfg, spec, p, x, attn_out, m_out):
    """The rest of an attention layer once its attention (and, for a
    hybrid layer, its Mamba) output exists: fuse, post-norm, residual,
    feed-forward. Returns x."""
    if m_out is not None:
        attn_out = _fuse_hybrid(p, attn_out, m_out)
    if "ln1_post" in p:
        attn_out = apply_norm(cfg, p["ln1_post"], attn_out)
    x = x + attn_out
    mlp_out, _ = _apply_ffn(cfg, spec, p, apply_norm(cfg, p["ln2"], x))
    if "ln2_post" in p:
        mlp_out = apply_norm(cfg, p["ln2_post"], mlp_out)
    return x + mlp_out


def apply_layer_decode_paged(cfg, spec: LayerSpec, p, cache, x, pos_b,
                             tables, page_size: int):
    """One-token layer step with per-sequence positions.

    x: (B, 1, D); pos_b: (B,) tokens already cached per sequence;
    tables: (B, TW) int32 physical page per ring slot; ``cache``: this
    layer's views — {"k","v"} pools (NP, ps, Hkv, D) under "pages" and
    the recurrent states (B, ...) under "mamba" or "cell", all written
    in place.
    """
    if spec.kind in _CELLS:
        return _cell_step(cfg, spec, p, cache, x)
    pages = cache["pages"]
    h = apply_norm(cfg, p["ln1"], x)
    q_pos = pos_b[:, None]                        # (B, 1) per-sequence
    k_new, v_new = _project_kv(cfg, p["attn"], h, q_pos)
    phys, slot = paged_phys_pages(tables, pos_b, page_size)
    idx = (phys.long(), slot.long())
    _pool_write(pages["k"], idx, k_new[:, 0])     # in place (JAX: donated)
    _pool_write(pages["v"], idx, v_new[:, 0])
    q = apply_rope(_proj_heads(h, p["attn"]["wq"]), q_pos, cfg.rope_theta)
    out = _paged_attn(cfg, q[:, 0], pages, tables, pos_b + 1, spec.window)
    H, P, D = p["attn"]["wo"].shape
    attn_out = (out.reshape(-1, H * P) @ p["attn"]["wo"].reshape(H * P, D)
                )[:, None]
    m_out = None
    if spec.kind == "hybrid":
        m_out, new = ssm.mamba_scan(cfg, p["mamba"], h, cache["mamba"])
        _store_state(cache["mamba"], new)
    return _attn_ffn_tail(cfg, spec, p, x, attn_out, m_out)


def apply_stack_decode_paged(cfg: ModelConfig, stack_params, caches, x,
                             pos_b, tables, page_size: int):
    """One fixed-shape continuous-batching step through all layers; the
    pools and states in ``caches`` are updated in place. Returns y (B, 1,
    D)."""
    for spec, p, cache in iter_layers(cfg, stack_params, caches):
        x = apply_layer_decode_paged(cfg, spec, p, cache, x, pos_b, tables,
                                     page_size)
    return x


def apply_layer_prefill_paged(cfg, spec: LayerSpec, p, cache, x,
                              n_valid: int, slot: int, table_row,
                              page_size: int):
    """Chunked prefill of ONE batch slot, writing K/V into its pages.

    x: (1, S, D) — the slot's prompt padded to the static chunk length S;
    n_valid: real token count (the pad tail's K/V goes to the trash page;
    causal masking makes pad queries invisible to real rows). Recurrent
    sub-layers scan from a FRESH zero state and store the result at row
    ``slot`` — exact only when n_valid == S, which the engine guarantees
    by routing recurrent families through the exact-length prefix fill
    and the step prefill.
    """
    if spec.kind in _CELLS:
        scan, init_state = _CELLS[spec.kind]
        y, new = scan(cfg, p["cell"], apply_norm(cfg, p["ln1"], x),
                      init_state(cfg, 1, x.dtype, x.device))
        _store_state(cache["cell"], new, slot)
        return x + y
    pages = cache["pages"]
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    h = apply_norm(cfg, p["ln1"], x)
    k, v = _project_kv(cfg, p["attn"], h, positions)
    TW = table_row.shape[0]
    tok_page = table_row[torch.remainder(
        torch.div(positions, page_size, rounding_mode="floor"), TW)].long()
    # only the last TW*ps positions can survive the ring; dropping older
    # writes also keeps the scatter free of duplicate (page, slot) pairs
    valid = (positions < n_valid) & (positions >= n_valid - TW * page_size)
    phys = torch.where(valid, tok_page, torch.full_like(tok_page, TRASH_PAGE))
    pslot = torch.where(valid, torch.remainder(positions, page_size),
                        torch.zeros_like(positions))
    _pool_write(pages["k"], (phys, pslot), k[0])  # in place (JAX: donated)
    _pool_write(pages["v"], (phys, pslot), v[0])
    attn_out = _attn_call(cfg, p["attn"], h, positions, k, v, positions,
                          spec.window)
    m_out = None
    if spec.kind == "hybrid":
        m_out, new = ssm.mamba_scan(cfg, p["mamba"], h,
                                    ssm.init_mamba_state(cfg, 1, x.dtype,
                                                         x.device))
        _store_state(cache["mamba"], new, slot)
    return _attn_ffn_tail(cfg, spec, p, x, attn_out, m_out)


def apply_stack_prefill_paged(cfg: ModelConfig, stack_params, caches, x,
                              n_valid: int, slot: int, table_row,
                              page_size: int):
    """Chunk-prefill one slot through all layers (pools and the slot's
    states written in place). Returns y (1, S, D)."""
    for spec, p, cache in iter_layers(cfg, stack_params, caches):
        x = apply_layer_prefill_paged(cfg, spec, p, cache, x, n_valid, slot,
                                      table_row, page_size)
    return x


# ------------------------------------------------------------------
# whole-batch decode path (contiguous ring cache)
# ------------------------------------------------------------------
#
# The whole-batch engine's caches: per spec, the attention layers' K/V
# rings ``"attn"`` {"k", "v"} (L, B, C, Hkv, D) and the recurrent states
# (``"mamba"``, ``"cell"``) stacked on L. One position for the whole
# batch: the prefill runs every sequence from 0, the decode step writes
# slot ``pos % C`` of every row.


def _write_prefill_cache(attn_cache, k, v, positions):
    """Populate the ring cache from a full-sequence prefill, in place.
    Only the last C positions can survive in a ring of size C."""
    C = attn_cache["k"].shape[1]
    if k.shape[1] >= C:
        k, v, positions = k[:, -C:], v[:, -C:], positions[-C:]
    slots = torch.remainder(positions, C).long()
    attn_cache["k"].index_copy_(1, slots, k.to(attn_cache["k"].dtype))
    attn_cache["v"].index_copy_(1, slots, v.to(attn_cache["v"].dtype))


def apply_layer_prefill(cfg, spec: LayerSpec, p, cache, x, positions):
    """Full-sequence forward of one layer that also populates its cache
    (in place): the K/V ring from the whole prompt, and each recurrent
    state after a scan of the whole prompt from the cache's state (no
    pads, so the state is exact). Attention runs ``cfg.attn_impl``: the
    flash kernel on the card under ``flash_pallas``. Returns x."""
    if spec.kind in _CELLS:
        return _cell_step(cfg, spec, p, cache, x)
    h = apply_norm(cfg, p["ln1"], x)
    k, v = _project_kv(cfg, p["attn"], h, positions)
    _write_prefill_cache(cache["attn"], k, v, positions)
    attn_out = _attn_call(cfg, p["attn"], h, positions, k, v, positions,
                          spec.window)
    m_out = None
    if spec.kind == "hybrid":
        m_out, new = ssm.mamba_scan(cfg, p["mamba"], h, cache["mamba"])
        _store_state(cache["mamba"], new)
    return _attn_ffn_tail(cfg, spec, p, x, attn_out, m_out)


def apply_stack_prefill(cfg: ModelConfig, stack_params, caches, x,
                        positions):
    """Prefill through all layers, caches written in place. Returns y."""
    for spec, p, cache in iter_layers(cfg, stack_params, caches):
        x = apply_layer_prefill(cfg, spec, p, cache, x, positions)
    return x


def init_layer_cache(cfg, spec: LayerSpec, batch, seq_len, dtype, device):
    """One layer's contiguous cache (no leading layer axis)."""
    cache = {}
    if spec.kind in ("attn", "hybrid"):
        c = init_attn_cache(1, batch, attn_cache_len(seq_len, spec.window),
                            cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
                            device)
        cache["attn"] = {k: v[0] for k, v in c.items()}
    if spec.kind == "hybrid":
        cache["mamba"] = ssm.init_mamba_state(cfg, batch, dtype, device)
    if spec.kind in _CELLS:
        cache["cell"] = _CELLS[spec.kind][1](cfg, batch, dtype, device)
    return cache


def init_stack_cache(cfg: ModelConfig, batch, seq_len, dtype, device):
    """Per-spec caches of :func:`init_layer_cache`, stacked on the
    super-block axis."""
    pattern = block_pattern(cfg)
    n_blocks = cfg.n_layers // len(pattern)

    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return tree.expand(n_blocks, *tree.shape).clone()

    return [stacked(init_layer_cache(cfg, spec, batch, seq_len, dtype,
                                     device)) for spec in pattern]


def apply_layer_decode(cfg, spec: LayerSpec, p, cache, x, pos):
    """One-token layer step. x: (B, 1, D); pos: 0-dim int32 tensor (tokens
    so far). The token's K/V go to ring slot ``pos % C`` and the states
    are replaced, in place. Attention is the plain version over the ring
    (``run_attention`` at one query), as in the reference. Returns x."""
    if spec.kind in _CELLS:
        return _cell_step(cfg, spec, p, cache, x)
    h = apply_norm(cfg, p["ln1"], x)
    q_pos = pos.reshape(1)
    k_new, v_new = _project_kv(cfg, p["attn"], h, q_pos)
    ring = update_attn_cache(cache["attn"], k_new, v_new, pos)
    k_pos = cache_positions(ring["k"].shape[1], pos)
    attn_out = _attn_call(cfg, p["attn"], h, q_pos, ring["k"], ring["v"],
                          k_pos, spec.window)
    m_out = None
    if spec.kind == "hybrid":
        m_out, new = ssm.mamba_scan(cfg, p["mamba"], h, cache["mamba"])
        _store_state(cache["mamba"], new)
    return _attn_ffn_tail(cfg, spec, p, x, attn_out, m_out)


def apply_stack_decode(cfg: ModelConfig, stack_params, caches, x, pos):
    """One-token step through all layers, caches written in place.
    Returns y (B, 1, D)."""
    for spec, p, cache in iter_layers(cfg, stack_params, caches):
        x = apply_layer_decode(cfg, spec, p, cache, x, pos)
    return x
