"""LM assembly: embeddings (+ learned meta-token or vision prefix) ->
layer stack -> head, for the dense, MoE, ssm (xLSTM), hybrid (Hymba),
vlm (InternVL2) and audio (MusicGen) families.

Counterpart of ``repro.models.registry``. Parameters are a nested dict
with the JAX package's layout and leaf names (``embed`` (V, D), or
(CB, V, D) for audio; ``head`` (D, V), or (CB, D, V); ``vis_proj``
(d_vis, D) for the VLM; ``meta`` (n_meta, D) where the config has meta
tokens; ``stack``: one stacked dict per pattern spec; ``ln_f``), so the
bridge moves them leaf for leaf. :class:`LM` is the ``nn.Module`` face of
the model: it builds parameters on a device and runs the training loss,
the whole-batch decode entry points and the paged serving entry points
against a parameter tree it is handed, so a trainer can differentiate a
replica's tree and a server can hot-swap the tree between steps.

Batch conventions (a dict of tensors; targets only for the loss):
  dense/moe/ssm/hybrid : tokens (B, S) int, targets (B, S)
  vlm                  : + vis_embeds (B, n_vis, d_vis) f32, a stub
                         frontend's patch embeddings
  audio                : tokens/targets (B, S, n_codebooks): EnCodec
                         streams
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import apply_norm, init_norm, norm_dims, \
    normal_init, softcap
from repro_torch.models.types import ModelConfig


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_lm(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters on ``device`` (the card unless "cpu"), drawn from
    ``generator`` (which must live on that device)."""
    tfm.check_family(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    cb = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    params = {
        "embed": normal_init(generator, cb + (V, D), dtype, fan_in=D,
                             device=dev),
        "head": normal_init(generator, cb + (D, V), dtype, fan_in=D,
                            device=dev),
    }
    if cfg.family == "vlm":
        params["vis_proj"] = normal_init(generator, (cfg.d_vis, D), dtype,
                                         fan_in=cfg.d_vis, device=dev)
    if cfg.n_meta_tokens:
        params["meta"] = normal_init(generator, (cfg.n_meta_tokens, D),
                                     dtype, fan_in=D, device=dev)
    params["stack"] = tfm.init_stack(cfg, generator, dtype, dev)
    params["ln_f"] = init_norm(cfg, device=dev)
    return params


def param_dims(cfg: ModelConfig) -> dict:
    """The logical dims of every leaf of :func:`init_lm`'s tree, the
    reference's ``init_lm`` dims: ``embed`` and ``head`` split on
    ``vocab`` only (never FSDP's ``embed``), the stack's leaves led by
    ``layers``."""
    tfm.check_family(cfg)
    if cfg.family == "audio":
        d = {"embed": (None, "vocab", None), "head": (None, None, "vocab")}
    else:
        d = {"embed": ("vocab", None), "head": (None, "vocab")}
    if cfg.family == "vlm":
        d["vis_proj"] = (None, "embed")
    if cfg.n_meta_tokens:
        d["meta"] = (None, "embed")
    d["stack"] = tfm.stack_dims(cfg)
    d["ln_f"] = norm_dims(cfg)
    return d


def _embed_tokens(cfg, params, tokens):
    """The embedding rows of ``tokens``. Through ``F.embedding``, not an
    index: its backward adds each row's gradients in a fixed order on
    both devices, where the index's ``index_put_`` accumulates in
    parallel on the CPU in whatever order its threads meet, so that two
    runs of the same step differ and a resumed run could not be bit-exact
    (``resilience.session``). Audio tokens (..., CB) sum their
    codebooks' rows as the reference does: ``0 + p0 + p1 + ...`` in the
    model dtype (a Python ``sum``: a stacked reduction may add in
    another order)."""
    if cfg.family == "audio":
        return sum(nn.functional.embedding(tokens[..., c].long(),
                                           params["embed"][c])
                   for c in range(cfg.n_codebooks))
    return nn.functional.embedding(tokens.long(), params["embed"])


def _prefix_len(cfg) -> int:
    """Prefix positions ahead of the prompt: Hymba's meta tokens, the
    VLM's vision tokens."""
    n = cfg.n_meta_tokens
    if cfg.family == "vlm":
        n += cfg.n_vis_tokens
    return n


def _meta_prefix(params, batch_size: int):
    """The meta tokens, (batch_size, n_meta, D)."""
    return params["meta"].expand(batch_size, *params["meta"].shape)


def _prefix(cfg, params, batch_size: int, vis_embeds):
    """The prefix parts in order: meta tokens, then the vision tokens
    (the patch embeddings cast to the model dtype and then projected, in
    the reference's order)."""
    parts = []
    if cfg.n_meta_tokens:
        parts.append(_meta_prefix(params, batch_size))
    if cfg.family == "vlm":
        vis = params["vis_proj"]
        parts.append(vis_embeds.to(vis.device, vis.dtype) @ vis)
    return parts


def _assemble_input(cfg, params, batch):
    """Token embeddings behind any prefix (meta tokens, then the vision
    tokens). Returns (x, positions); the positions cover the prefix."""
    x = _embed_tokens(cfg, params, batch["tokens"])
    parts = _prefix(cfg, params, x.shape[0], batch.get("vis_embeds"))
    if parts:
        x = torch.cat(parts + [x], dim=1)
    return x, torch.arange(x.shape[1], device=x.device)


def _drop_prefix(cfg, x):
    """The token positions of x: the head sees no prefix position."""
    npre = _prefix_len(cfg)
    return x[:, npre:] if npre else x


def _head(cfg, params, x):
    """f32 logits (..., V), or (..., CB, V) for audio's per-codebook
    heads."""
    if cfg.family == "audio":
        logits = torch.einsum("...d,cdv->...cv", x, params["head"])
    else:
        logits = x @ params["head"]
    return softcap(logits.float(), cfg.final_softcap)


# ------------------------------------------------------------------
# training path
# ------------------------------------------------------------------


def lm_apply(cfg: ModelConfig, params, batch):
    """Teacher-forcing forward. Returns (logits (B, S, V) f32, or (B, S,
    CB, V) for audio, aux)."""
    x, positions = _assemble_input(cfg, params, batch)
    x, aux = tfm.apply_stack_train(cfg, params["stack"], x, positions)
    x = _drop_prefix(cfg, apply_norm(cfg, params["ln_f"], x))
    return _head(cfg, params, x), aux


def _xent(logits, targets):
    """Mean token cross-entropy in f32. logits (..., V), targets (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


_XENT_CHUNK = 512


def _chunk_sums(cfg, head, xb, tb):
    logits = _head(cfg, {"head": head}, xb)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tb.long()[..., None])[..., 0]
    return torch.sum(logz - gold), \
        torch.sum((torch.argmax(logits, -1) == tb).float())


def _head_and_xent(cfg, params, x, targets):
    """Final projection + cross-entropy, chunked over the sequence as the
    reference chunks it: past 512 tokens (and at a multiple of 512) each
    512-token slice's logits are recomputed in the backward
    (``torch.utils.checkpoint``), which bounds the f32 logits held at
    (B, 512, V) ((B, 512, CB, V) for audio's (B, S, CB) targets). Returns
    (loss_mean, acc_mean)."""
    S = targets.shape[1]
    if S % _XENT_CHUNK or S <= _XENT_CHUNK:
        logits = _head(cfg, params, x)
        acc = torch.mean((torch.argmax(logits, -1) == targets).float())
        return _xent(logits, targets), acc
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    acc_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, _XENT_CHUNK):
        xb, tb = x[:, c:c + _XENT_CHUNK], targets[:, c:c + _XENT_CHUNK]
        if torch.is_grad_enabled():
            l, a = checkpoint(_chunk_sums, cfg, params["head"], xb, tb,
                              use_reentrant=False)
        else:
            l, a = _chunk_sums(cfg, params["head"], xb, tb)
        loss_sum, acc_sum = loss_sum + l, acc_sum + a
    n_tok = targets.numel()
    return loss_sum / n_tok, acc_sum / n_tok


def _embed_par(cfg, embed, tokens, par):
    """The vocab-split embedding (the reference's ``_sharded_gather``):
    each model rank looks up the tokens inside its block of rows, zero
    elsewhere, and the rows are summed over ``model``; the backward
    reaches only the rank's own rows."""
    V_l = embed.shape[0]
    lid = tokens.long() - par.tp_index * V_l
    ok = (lid >= 0) & (lid < V_l)
    rows = nn.functional.embedding(lid.clamp(0, V_l - 1), embed)
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return par.reduce_from_model(rows)


def _xent_par(cfg, head, x, targets, par):
    """Cross-entropy over a vocab-split head: each model rank's logits
    cover its block of the vocab; the max and the sum of exponentials,
    and the target's logit, are summed (the max gathered) over ``model``.
    Returns (loss_mean, acc_mean); the accuracy takes the first index of
    the global max, as ``argmax`` does."""
    logits = softcap((par.copy_to_model(x) @ head).float(),
                     cfg.final_softcap)                      # (B, S, V_l)
    V_l = logits.shape[-1]
    lo = par.tp_index * V_l
    with torch.no_grad():
        lmax, lidx = logits.max(-1)
        both = par.gather_model(torch.stack([lmax, (lidx + lo).float()]))
        gmax, win = both[:, 0].max(0)        # the first rank at the max
        first = both[:, 1].gather(0, win[None])[0]
    sumexp = par.reduce_from_model(torch.exp(logits - gmax[..., None])
                                   .sum(-1))
    t = targets.long() - lo
    ok = (t >= 0) & (t < V_l)
    gold = torch.gather(logits, -1, t.clamp(0, V_l - 1)[..., None])[..., 0]
    gold = par.reduce_from_model(torch.where(ok, gold, torch.zeros(
        (), dtype=gold.dtype, device=gold.device)))
    loss = torch.mean(torch.log(sumexp) + gmax - gold)
    acc = torch.mean((first.long() == targets.long()).float())
    return loss, acc


def _lm_loss_par(cfg: ModelConfig, params, batch, par):
    """:func:`lm_loss` with a data or model axis inside the replica
    (``models.parallel.Par``): ``params`` are the rank's blocks, ``batch``
    its rows. The leaves outside the stack are prepared (FSDP's gathers)
    once; the stack's a layer at a time. With a model axis the vocab is
    split where it divides (the embedding's masked lookup, the
    vocab-parallel cross-entropy) and whole elsewhere; a prefix (hymba's
    meta tokens) is whole on every rank."""
    top = {k: v for k, v in params.items() if k != "stack"}
    top = par.prepare(top, {k: v for k, v in par.places.items()
                            if k != "stack"})
    vocab_split = par.splits(cfg.vocab_size)
    if vocab_split:
        x = _embed_par(cfg, top["embed"], batch["tokens"], par)
    else:
        x = _embed_tokens(cfg, top, batch["tokens"])
    parts = _prefix(cfg, top, x.shape[0], batch.get("vis_embeds"))
    if parts:
        x = torch.cat(parts + [x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = tfm.apply_stack_train(cfg, params["stack"], x, positions,
                                   par=par)
    x = _drop_prefix(cfg, apply_norm(cfg, top["ln_f"], x))
    if vocab_split:
        loss, acc = _xent_par(cfg, top["head"], x, batch["targets"], par)
    else:
        loss, acc = _head_and_xent(cfg, top, x, batch["targets"])
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux": aux, "acc": acc}


def lm_loss(cfg: ModelConfig, params, batch, par=None):
    """Returns (total, {"loss", "aux", "acc"}): total = mean token
    cross-entropy + router_aux_coef * aux. ``par`` (``models.parallel``)
    runs a rank's part of a replica split over data and model axes."""
    if par is not None:
        return _lm_loss_par(cfg, params, batch, par)
    x, positions = _assemble_input(cfg, params, batch)
    x, aux = tfm.apply_stack_train(cfg, params["stack"], x, positions)
    x = _drop_prefix(cfg, apply_norm(cfg, params["ln_f"], x))
    loss, acc = _head_and_xent(cfg, params, x, batch["targets"])
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux": aux, "acc": acc}


# ------------------------------------------------------------------
# whole-batch decode path (contiguous ring cache)
# ------------------------------------------------------------------


def lm_init_cache(cfg: ModelConfig, batch_size: int, seq_len: int,
                  dtype=None, device=None):
    """The whole-batch engine's cache: per-spec K/V rings and recurrent
    states for ``seq_len`` tokens plus the model's prefix, and ``pos``
    (0-dim int32, tokens consumed so far)."""
    dev = resolve_device(device)
    total = seq_len + _prefix_len(cfg)
    return {"layers": tfm.init_stack_cache(cfg, batch_size, total,
                                           dtype or _dtype(cfg), dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def lm_prefill(cfg: ModelConfig, params, cache, batch):
    """Batched prefill: the full forward over (prefix +) prompt, every
    layer's cache populated in place. Returns (last-token logits (B, V)
    or (B, CB, V) f32, cache positioned after the prompt)."""
    x, positions = _assemble_input(cfg, params, batch)
    x = tfm.apply_stack_prefill(cfg, params["stack"], cache["layers"], x,
                                positions)
    x = apply_norm(cfg, params["ln_f"], x)[:, -1]
    cache["pos"] = torch.full((), positions.shape[0], dtype=torch.int32,
                              device=x.device)
    return _head(cfg, params, x), cache


@torch.no_grad()
def lm_decode_step(cfg: ModelConfig, params, cache, tokens):
    """One-token decode. tokens: (B,) int (or (B, CB) for audio). The
    cache is written in place. Returns (logits (B, V) or (B, CB, V) f32,
    cache)."""
    x = _embed_tokens(cfg, params, tokens[:, None])          # (B, 1, D)
    pos = cache["pos"]
    x = tfm.apply_stack_decode(cfg, params["stack"], cache["layers"], x, pos)
    x = apply_norm(cfg, params["ln_f"], x)[:, 0]
    cache["pos"] = pos + 1
    return _head(cfg, params, x), cache


# ------------------------------------------------------------------
# paged serving path
# ------------------------------------------------------------------


def lm_init_paged_cache(cfg: ModelConfig, max_batch: int, n_pages: int,
                        page_size: int, dtype=None, device=None):
    """Serving caches: per-spec page pools and stacked recurrent
    states."""
    return tfm.init_stack_paged_cache(cfg, max_batch, n_pages, page_size,
                                      dtype or _dtype(cfg),
                                      resolve_device(device))


@torch.no_grad()
def lm_paged_decode_step(cfg: ModelConfig, params, caches, tokens, pos_b,
                         tables, page_size: int):
    """One fixed-shape continuous-batching token step.

    tokens: (B,) int ((B, CB) for audio); pos_b: (B,) int32
    per-sequence positions (tokens already cached — inactive slots carry
    pos 0 and write the trash page); tables: (B, TW) int32 block tables.
    The pools in ``caches`` are written in place. Returns (logits (B, V)
    or (B, CB, V) f32, caches).
    """
    x = _embed_tokens(cfg, params, tokens[:, None])          # (B, 1, D)
    x = tfm.apply_stack_decode_paged(cfg, params["stack"], caches, x, pos_b,
                                     tables, page_size)
    x = apply_norm(cfg, params["ln_f"], x)[:, 0]
    return _head(cfg, params, x), caches


@torch.no_grad()
def lm_paged_prefill_chunk(cfg: ModelConfig, params, caches, batch,
                           n_valid: int, slot: int, tables, page_size: int):
    """Prefill ONE batch slot's prompt chunk into its pages.

    batch: single-sequence batch dict (tokens (1, S_pad), or (1, S_pad,
    CB), + vis_embeds (1, n_vis, d_vis) for the VLM) padded to the
    engine's static chunk length; n_valid: real token count INCLUDING
    the meta/vision prefix; slot: batch-slot index. Exact for
    attention-only stacks at any n_valid (pad K/V goes to the trash
    page, causal masking hides pad queries); recurrent stacks
    additionally need n_valid == S_total, so the engine routes them
    through :func:`lm_paged_prefix_fill` and the step prefill instead.
    Returns
    (next-token logits (1, V) or (1, CB, V) f32, caches), written in
    place.
    """
    x, _ = _assemble_input(cfg, params, batch)               # (1, S, D)
    x = tfm.apply_stack_prefill_paged(cfg, params["stack"], caches, x,
                                      n_valid, slot, tables[slot], page_size)
    x = apply_norm(cfg, params["ln_f"], x)
    return _head(cfg, params, x[:, n_valid - 1]), caches


@torch.no_grad()
def lm_paged_prefix_fill(cfg: ModelConfig, params, caches, slot: int, tables,
                         page_size: int, vis_embeds=None):
    """Run the prefix (meta tokens; vision tokens from ``vis_embeds`` (1,
    n_vis, d_vis) for the VLM) for one slot at its exact static length,
    so the slot's recurrent states are exact: its K/V go to the slot's
    pages and each recurrent layer's state after the prefix to row
    ``slot``. The engine then feeds the prompt through the decode step
    (step prefill). Returns the caches, written in place."""
    npre = _prefix_len(cfg)
    if not npre:
        raise ValueError("prefix fill on a model without a prefix")
    x = torch.cat(_prefix(cfg, params, 1, vis_embeds), dim=1)
    tfm.apply_stack_prefill_paged(cfg, params["stack"], caches, x, npre,
                                  slot, tables[slot], page_size)
    return caches


class LM(nn.Module):
    """The LM of one of the ported families. Holds the config; parameters
    are a tree the caller owns (``init`` makes one), so the serving
    engine can swap weights between steps without touching the
    module."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        tfm.check_family(cfg)
        self.cfg = cfg

    def init(self, generator: torch.Generator, device=None):
        return init_lm(self.cfg, generator, device)

    def abstract(self):
        """(parameter tree on the ``meta`` device, logical dims): shapes
        and dtypes without allocating, the reference's ``lm.abstract()``.
        """
        return init_lm(self.cfg, None, "meta"), param_dims(self.cfg)

    def apply(self, params, batch):
        return lm_apply(self.cfg, params, batch)

    def loss(self, params, batch, par=None):
        return lm_loss(self.cfg, params, batch, par)

    def init_cache(self, batch_size, seq_len, dtype=None, device=None):
        return lm_init_cache(self.cfg, batch_size, seq_len, dtype, device)

    def prefill(self, params, cache, batch):
        return lm_prefill(self.cfg, params, cache, batch)

    def decode_step(self, params, cache, tokens):
        return lm_decode_step(self.cfg, params, cache, tokens)

    def init_paged_cache(self, max_batch, n_pages, page_size, dtype=None,
                         device=None):
        return lm_init_paged_cache(self.cfg, max_batch, n_pages, page_size,
                                   dtype, device)

    def paged_decode_step(self, params, caches, tokens, pos_b, tables,
                          page_size):
        return lm_paged_decode_step(self.cfg, params, caches, tokens, pos_b,
                                    tables, page_size)

    def paged_prefill_chunk(self, params, caches, batch, n_valid, slot,
                            tables, page_size):
        return lm_paged_prefill_chunk(self.cfg, params, caches, batch,
                                      n_valid, slot, tables, page_size)

    def paged_prefix_fill(self, params, caches, slot, tables, page_size,
                          vis_embeds=None):
        return lm_paged_prefix_fill(self.cfg, params, caches, slot, tables,
                                    page_size, vis_embeds=vis_embeds)

    def forward(self, params, caches, tokens, pos_b, tables, page_size):
        """The serving step: :meth:`paged_decode_step`."""
        return self.paged_decode_step(params, caches, tokens, pos_b, tables,
                                      page_size)


def build_model(cfg: ModelConfig) -> LM:
    if cfg.family == "convnet":
        raise ValueError("use repro_torch.models.convnet directly for "
                         "convnets")
    return LM(cfg)
