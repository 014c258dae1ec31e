"""Serving engines: prefill + greedy/temperature decode.

Counterpart of ``repro.serve.engine``. Two engines share the model's
functions:

- :class:`DecodeEngine`: the whole-batch engine, a static batch over a
  contiguous ``(L, B, C, Hkv, D)`` ring cache, sampling and decode fused
  in one step. It is the reference's default engine and the oracle the
  paged engine is held to.
- :class:`PagedDecodeEngine`: a page-pool KV
cache with per-sequence block tables, ONE decode step over fixed
(max_batch, pool) shapes so admissions and evictions never change a
shape, sampling on the device, and an on-device output buffer (no
per-token host syncs). Weight hot-swap is a reference swap
(``set_params``) between steps.

PyTorch runs eagerly, so there is no jit and no trace count; the step's
control arrays go to the device once per step (as ``jnp.asarray`` does
in the reference), the page pools, the last tokens and the output buffer
are written in place (:func:`paged_decode_step`, which
:func:`make_paged_decode_bundle` offers to the contract checker), and
tokens and the output buffer stay on the device until a request
finishes. Recurrent
stacks (xLSTM, Hymba) run the exact-length prefix fill at admission and
then take their prompt one token a step through the decode step (step
prefill).

Both serve every ported family, multi-codebook audio included: its
tokens, last sampled tokens and output buffer carry a trailing CB axis,
and the model sees plain parallel streams. MusicGen's delay pattern
(codebook c shifted c steps) is offered as :func:`apply_delay_pattern`
and :func:`undo_delay_pattern`; no engine applies it, as in the
reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.cache import paged_table_width
from repro_torch.models.registry import (LM, _prefix_len,
                                         lm_paged_decode_step,
                                         lm_paged_prefill_chunk,
                                         lm_paged_prefix_fill)
from repro_torch.serve.pages import PageManager


def apply_delay_pattern(tokens, pad_token: int = 0):
    """(B, S, CB) -> (B, S+CB-1, CB) with codebook c delayed by c steps."""
    B, S, CB = tokens.shape
    out = torch.full((B, S + CB - 1, CB), pad_token, dtype=tokens.dtype,
                     device=tokens.device)
    for c in range(CB):
        out[:, c:c + S, c] = tokens[..., c]
    return out


def undo_delay_pattern(tokens, n_frames: int):
    """(B, S+CB-1, CB) -> (B, n_frames, CB)."""
    CB = tokens.shape[-1]
    return torch.stack([tokens[:, c:c + n_frames, c] for c in range(CB)],
                       dim=-1)


def _sample(logits, generator, temperature: float):
    """Argmax at temperature 0; otherwise a categorical draw from the
    engine's device generator (not JAX's bits). logits (..., V)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator)[:, 0] \
        .reshape(probs.shape[:-1])


def _as_tensor(x, device, dtype):
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return x.to(device, dtype)


def _batch_to_device(batch, device):
    """A batch dict of arrays or tensors as the model takes it: int64
    tokens and f32 ``vis_embeds`` on ``device`` (other keys dropped)."""
    out = {"tokens": _as_tensor(batch["tokens"], device, torch.int64)}
    if batch.get("vis_embeds") is not None:
        out["vis_embeds"] = _as_tensor(batch["vis_embeds"], device,
                                       torch.float32)
    return out


@dataclasses.dataclass
class DecodeEngine:
    """Whole-batch engine: a static batch, a contiguous cache, one prefill
    of the whole batch (the flash kernel at B = batch under
    ``flash_pallas``), then one fused step a token (sample the previous
    logits, decode). Sampling draws from a ``torch.Generator`` on the
    engine's device. ``device`` defaults to the card."""
    lm: LM
    params: object
    max_seq_len: int
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def step(self, cache, logits, generator, temperature: float):
        """Sample from ``logits`` and decode the sample: (token, next
        logits, cache)."""
        tok = _sample(logits, generator, temperature).to(torch.int32)
        logits, cache = self.lm.decode_step(self.params, cache, tok)
        return tok, logits, cache

    def generate(self, batch, n_new_tokens: int, *, temperature: float = 0.0,
                 seed: int = 0):
        """Prefill ``batch`` (tokens (B, S) or (B, S, CB), + vis_embeds for
        the VLM) then decode ``n_new_tokens`` greedily or sampled.
        Returns int32 tokens on the device: (B, n_new) or (B, n_new, CB)
        for audio."""
        b = _batch_to_device(batch, self.device)
        cache = self.lm.init_cache(b["tokens"].shape[0], self.max_seq_len,
                                   device=self.device)
        logits, cache = self.lm.prefill(self.params, cache, b)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        outs = []
        for _ in range(n_new_tokens):
            tok, logits, cache = self.step(cache, logits, gen, temperature)
            outs.append(tok)
        return torch.stack(outs, dim=1)


def model_table_width(cfg, max_seq_len: int, page_size: int) -> int:
    """ONE table width per model: the max over the pattern's attention
    specs (a global layer forces full history; pure-windowed patterns get
    the small ring). 1 for attention-free stacks (tables unused)."""
    widths = [paged_table_width(max_seq_len, s.window, page_size)
              for s in tfm.block_pattern(cfg) if s.kind in ("attn", "hybrid")]
    return max(widths) if widths else 1


def needs_exact_prefill(cfg) -> bool:
    """Recurrent stacks (mamba/mLSTM/sLSTM) cannot absorb pad tokens in a
    chunked prefill: the engine routes them through the prefix fill and
    the step prefill instead."""
    return any(s.kind in ("hybrid", "mlstm", "slstm")
               for s in tfm.block_pattern(cfg))


def paged_decode_step(cfg, params, caches, last, out, generator, ctrl, *,
                      page_size: int, temperature: float = 0.0):
    """The paged engine's decode step on its state, in place: zero the
    recurrent states of the slots flagged in ``ctrl["reset"]``, feed each
    slot its prompt token (``use_prompt``) or its last sample, one
    ``lm_paged_decode_step`` (the pools written in place), sample, write
    the samples into ``last`` and into ``out`` at ``out_idx``. ``ctrl``
    holds device tensors: tables (B,TW) i32, pos (B,) i32, use_prompt
    (B,) bool, prompt_tok (B,)/(B,CB) i32, out_idx (B,) i32, reset (B,)
    bool. Returns (caches, last, out, logits)."""
    caches = tfm.reset_paged_states(caches, ctrl["reset"])
    up = ctrl["use_prompt"]
    upb = up if last.ndim == 1 else up[:, None]
    tok_in = torch.where(upb, ctrl["prompt_tok"], last)
    logits, caches = lm_paged_decode_step(
        cfg, params, caches, tok_in, ctrl["pos"], ctrl["tables"], page_size)
    sampled = _sample(logits, generator, temperature).to(torch.int32)
    last.copy_(sampled)
    out[torch.arange(out.shape[0], device=out.device),
        ctrl["out_idx"].long()] = sampled
    return caches, last, out, logits


def make_paged_decode_bundle(lm: LM, *, max_batch: int = 2,
                             max_seq_len: int = 64, max_new: int = 4,
                             page_size: int = 4, temperature: float = 0.0):
    """The paged decode step as a ``StepBundle`` for the contract checker
    (the reference's bundle and defaults): ``fn(params, caches, last,
    out, generator, ctrl) -> (caches, last, out, logits)``, the engine's
    own :func:`paged_decode_step`. Its contract
    (``analysis.contracts.decode_contract``): no collectives anywhere,
    the paged kernel once an attention layer under ``flash_pallas`` (0
    otherwise), the caches, the last tokens and the output written in
    place, its working set the f32 logits and the sampler's copy of
    them, no f64. ``max_batch``, ``max_seq_len`` and ``max_new`` size
    the engine the caller builds the state from
    (:class:`PagedDecodeEngine`)."""
    from repro_torch.analysis.contracts import PEAK_SLACK, decode_contract
    from repro_torch.launch.sync.bundles import StepBundle
    cfg = lm.cfg
    n_attn = sum(1 for s in tfm.block_pattern(cfg)
                 if s.kind in ("attn", "hybrid")) * (
        cfg.n_layers // len(tfm.block_pattern(cfg)))

    def step(params, caches, last, out, generator, ctrl):
        return paged_decode_step(cfg, params, caches, last, out, generator,
                                 ctrl, page_size=page_size,
                                 temperature=temperature)
    return StepBundle(
        fn=step, donate_argnums=(1, 2, 3),
        carry=lambda args, o: (args[0], o[0], o[1], o[2], args[4], args[5]),
        contract=decode_contract(
            launches={"paged_attention": n_attn}
            if cfg.attn_impl == "flash_pallas" else {},
            peak_bytes=2 * 4 * max_batch * cfg.vocab_size * (
                cfg.n_codebooks if cfg.family == "audio" else 1)
            + PEAK_SLACK,
            notes=f"paged continuous-batching decode step (B {max_batch}, "
                  f"{max_seq_len} tokens, {max_new} new, page {page_size})"))


@dataclasses.dataclass
class PagedDecodeEngine:
    """Fixed-shape continuous-batching engine over a paged KV pool.

    ``max_seq_len`` bounds TOTAL tokens per sequence (prefix + prompt +
    generated);
    ``max_new`` bounds generated tokens (sizes the on-device output
    buffer); ``prefill_chunk`` is the static padded prompt length of the
    chunk prefill. ``device`` defaults to the card; without one, building
    the engine raises unless ``device="cpu"`` is passed.
    """
    lm: LM
    params: object
    max_batch: int
    max_seq_len: int
    max_new: int
    page_size: int = 4
    n_pages: int | None = None
    prefill_chunk: int = 32
    temperature: float = 0.0
    seed: int = 0
    device: str | torch.device | None = None

    def __post_init__(self):
        cfg = self.lm.cfg
        self.device = resolve_device(self.device)
        self.table_width = model_table_width(cfg, self.max_seq_len,
                                             self.page_size)
        if self.n_pages is None:
            self.n_pages = 1 + self.max_batch * self.table_width
        self.needs_exact_prefill = needs_exact_prefill(cfg)
        self.prefix_len = _prefix_len(cfg)
        self.reset_state(self.seed)

    # ------------------------------------------------------------ state

    def reset_state(self, seed: int = 0):
        """Fresh caches / output buffer / generator / page manager."""
        dev = self.device
        cfg = self.lm.cfg
        caches = self.lm.init_paged_cache(self.max_batch, self.n_pages,
                                          self.page_size, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        cb = (cfg.n_codebooks,) if cfg.family == "audio" else ()
        self.state = {
            "caches": caches,
            "last": torch.zeros((self.max_batch,) + cb, dtype=torch.int32,
                                device=dev),
            # last column = scratch for non-emitting steps
            "out": torch.zeros((self.max_batch, self.max_new + 1) + cb,
                               dtype=torch.int32, device=dev),
            "generator": gen,
            "logits": None,      # the latest step's logits, for inspection
        }
        self.pages = PageManager(self.n_pages, self.page_size,
                                 self.table_width, self.max_batch)

    @property
    def scratch_idx(self) -> int:
        """Output column absorbing non-emitting steps (prompt feed)."""
        return self.max_new

    # ------------------------------------------------------- host driver

    def set_params(self, new_params):
        """Weight hot-swap: the next :meth:`step` runs the new weights,
        in-flight state untouched."""
        self.params = new_params

    def step(self, ctrl: dict):
        """One fixed-shape decode step. ``ctrl`` holds host-built arrays:
        tables (B,TW) i32, pos (B,) i32, use_prompt (B,) bool,
        prompt_tok (B,)/(B,CB) i32, out_idx (B,) i32, reset (B,) bool.
        The recurrent states of the slots flagged in ``reset`` are zeroed
        first."""
        s = self.state
        c = {k: _as_tensor(v, self.device, torch.bool
                           if k in ("use_prompt", "reset") else torch.int32)
             for k, v in ctrl.items()}
        caches, _, _, logits = paged_decode_step(
            self.lm.cfg, self.params, s["caches"], s["last"], s["out"],
            s["generator"], c, page_size=self.page_size,
            temperature=self.temperature)
        s.update(caches=caches, logits=logits)

    def prefill_into(self, slot: int, batch1: dict, n_valid: int):
        """Chunk-prefill one slot: pads the prompt (tokens (1, S) or (1,
        S, CB); ``vis_embeds`` passed on) to ``prefill_chunk``, writes
        its pages, samples the first output token into ``out[slot, 0]``.
        One dispatch per admission."""
        tokens = np.asarray(batch1["tokens"])
        S = tokens.shape[1]
        if S > self.prefill_chunk:
            raise ValueError(f"prompt of {S} tokens exceeds prefill_chunk "
                             f"{self.prefill_chunk}")
        width = [(0, 0), (0, self.prefill_chunk - S)] + \
            [(0, 0)] * (tokens.ndim - 2)
        padded = dict(batch1, tokens=np.pad(tokens, width))
        s = self.state
        logits, caches = lm_paged_prefill_chunk(
            self.lm.cfg, self.params, s["caches"],
            _batch_to_device(padded, self.device), n_valid, slot,
            _as_tensor(self.pages.tables, self.device, torch.int32),
            self.page_size)
        sampled = _sample(logits, s["generator"],
                          self.temperature).to(torch.int32)[0]
        s["last"][slot] = sampled
        s["out"][slot, 0] = sampled
        s.update(caches=caches, logits=logits)

    def prefix_fill_into(self, slot: int):
        """Run the learned prefix (meta tokens) for one slot: the exact
        static-length entry point for recurrent stacks. Overwrites the
        slot's recurrent states."""
        lm_paged_prefix_fill(self.lm.cfg, self.params, self.state["caches"],
                             slot, _as_tensor(self.pages.tables, self.device,
                                              torch.int32),
                             self.page_size)

    def read_out(self, slot: int, n: int) -> np.ndarray:
        """Fetch one finished request's tokens — a single device->host
        copy per REQUEST, never per token."""
        return self.state["out"][slot, :n].to("cpu", copy=True).numpy()

    def apply_page_perm(self, perm: np.ndarray):
        """Re-gather the device pools after ``PageManager.defrag``:
        ``perm[old] = new`` => ``new_pool[new] = old_pool[old]``."""
        gather = torch.as_tensor(np.argsort(perm), device=self.device)
        for c in self.state["caches"]:
            if "pages" in c:
                c["pages"] = {k: v[:, gather] for k, v in c["pages"].items()}

    def generate(self, batch, n_new_tokens: int, *, seed: int = 0):
        """Whole-batch convenience wrapper (the counterpart of
        :meth:`DecodeEngine.generate` at temperature 0): admits all B
        sequences through the continuous scheduler at once. Returns (B,
        n_new) int32, or (B, n_new, CB) for audio, on the host."""
        from repro_torch.serve.scheduler import ContinuousScheduler, Request
        tokens = np.asarray(batch["tokens"])
        vis = batch.get("vis_embeds")
        vis = None if vis is None else np.asarray(
            vis.cpu() if torch.is_tensor(vis) else vis)
        reqs = [Request(rid=b, tokens=tokens[b], n_new=n_new_tokens,
                        vis_embeds=None if vis is None else vis[b])
                for b in range(tokens.shape[0])]
        outs = ContinuousScheduler(self).run(reqs, seed=seed)
        return torch.as_tensor(np.stack([outs[b] for b in range(len(reqs))]))
