"""Continuous-batching scheduler over the paged decode engine.

A copy of ``repro.serve.scheduler`` (host-side numpy bookkeeping). The
engine (``serve.engine.PagedDecodeEngine``) is mechanism: one
fixed-shape decode step plus per-admission prefill dispatches. This
module is the policy loop:

- **admission**: FIFO queue, admitted the moment a batch slot AND the
  request's exact worst-case page budget are free
  (``PageManager.can_admit`` — reservation up front means an admitted
  sequence can never run out of pages mid-decode, so no preemption path
  is needed).
- **prefill**: attention-only stacks prefill their whole (padded) prompt
  in one chunk dispatch at admission; recurrent stacks run the
  static-length prefix fill, then feed prompt tokens through the shared
  decode step (``use_prompt`` lane).
- **eviction**: a finished request's tokens are fetched with one
  device->host copy, its pages and slot freed, and the next queued
  request admitted into the hole, all without changing the step's shapes.

Every step's control arrays (block tables, positions, prompt lane,
output indices) are built host-side from this module's bookkeeping; the
device never sees a data-dependent shape.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request. ``tokens``: (S,) int32 ((S, CB) for audio);
    ``arrival``: earliest step index at which admission may happen (lets
    tests drive ragged arrival traces)."""
    rid: int
    tokens: np.ndarray
    n_new: int
    vis_embeds: np.ndarray | None = None
    arrival: int = 0


@dataclasses.dataclass
class _Active:
    req: Request
    slot: int
    pos: int              # tokens written to the cache so far
    fed: int              # prompt tokens already fed (step-prefill lane)
    emitted: int          # output tokens sampled so far
    fresh: bool = True    # first step must carry the recurrent-state reset


class ContinuousScheduler:
    """Drives admit → (prefill | decode) steps → evict until done."""

    def __init__(self, engine):
        self.engine = engine

    # ------------------------------------------------------------ admission

    def _total_len(self, req: Request) -> int:
        return self.engine.prefix_len + len(req.tokens) + req.n_new

    def _admit(self, req: Request) -> _Active:
        eng = self.engine
        total = self._total_len(req)
        assert total <= eng.max_seq_len, (total, eng.max_seq_len)
        assert req.n_new <= eng.max_new, (req.n_new, eng.max_new)
        slot = eng.pages.admit(total)
        npre = eng.prefix_len
        S = len(req.tokens)
        if not eng.needs_exact_prefill:
            # one chunk dispatch: pages for the whole prompt, first
            # output token sampled into out[slot, 0]
            eng.pages.touch_range(slot, 0, npre + S)
            batch1 = {"tokens": req.tokens[None]}
            if req.vis_embeds is not None:
                batch1["vis_embeds"] = req.vis_embeds[None]
            eng.prefill_into(slot, batch1, npre + S)
            return _Active(req=req, slot=slot, pos=npre + S, fed=S,
                           emitted=1, fresh=False)
        # recurrent stack: exact-length prefix fill, then the prompt is
        # fed through the shared decode step (use_prompt lane)
        if npre:
            eng.pages.touch_range(slot, 0, npre)
            eng.prefix_fill_into(slot)
        # prefix fill OVERWRITES the slot's recurrent state (fresh scan
        # from zeros), so only prefix-free stacks still need the reset
        return _Active(req=req, slot=slot, pos=npre, fed=0, emitted=0,
                       fresh=npre == 0)

    # ------------------------------------------------------------ main loop

    def run(self, requests: list[Request], *, seed: int = 0,
            max_steps: int | None = None) -> dict:
        """Serve ``requests`` to completion. Returns {rid: tokens
        (n_new,) or (n_new, CB)}. ``max_steps`` guards tests against a
        livelocked loop (raises instead of spinning)."""
        eng = self.engine
        eng.reset_state(seed)
        queue = sorted(requests, key=lambda r: (r.arrival, r.rid))
        active: dict[int, _Active] = {}          # slot -> state
        results: dict[int, np.ndarray] = {}
        B, scratch = eng.max_batch, eng.scratch_idx
        audio = eng.lm.cfg.family == "audio"
        cb = eng.lm.cfg.n_codebooks if audio else None
        step_i = 0
        while queue or active:
            if max_steps is not None and step_i > max_steps:
                raise RuntimeError("scheduler exceeded max_steps")
            # admit in arrival order while budget allows
            while queue and queue[0].arrival <= step_i and \
                    eng.pages.can_admit(self._total_len(queue[0])):
                act = self._admit(queue.pop(0))
                active[act.slot] = act
                self._maybe_finish(act, active, results)
            if not active:
                step_i += 1      # waiting on a future arrival
                continue

            ctrl = self._build_ctrl(active, B, scratch, audio, cb)
            eng.step(ctrl)
            step_i += 1

            for slot in list(active):
                act = active[slot]
                act.fresh = False
                act.pos += 1
                if act.fed < len(act.req.tokens):
                    act.fed += 1
                    if act.fed == len(act.req.tokens):
                        act.emitted = 1      # last prompt step emitted #0
                else:
                    act.emitted += 1
                self._maybe_finish(act, active, results)
        return results

    def _maybe_finish(self, act: _Active, active, results):
        if act.emitted >= act.req.n_new:
            eng = self.engine
            results[act.req.rid] = eng.read_out(act.slot, act.req.n_new)
            eng.pages.release(act.slot)
            active.pop(act.slot, None)

    # ----------------------------------------------------------- step ctrl

    def _build_ctrl(self, active, B, scratch, audio, cb):
        eng = self.engine
        tokf = (B, cb) if audio else (B,)
        pos = np.zeros((B,), np.int32)
        use_prompt = np.zeros((B,), bool)
        prompt_tok = np.zeros(tokf, np.int32)
        out_idx = np.full((B,), scratch, np.int32)
        reset = np.zeros((B,), bool)
        for slot, act in active.items():
            pos[slot] = act.pos
            reset[slot] = act.fresh
            eng.pages.touch(slot, act.pos)   # page for this step's write
            S = len(act.req.tokens)
            if act.fed < S:                   # prompt lane (step-prefill)
                use_prompt[slot] = True
                prompt_tok[slot] = act.req.tokens[act.fed]
                if act.fed == S - 1:
                    out_idx[slot] = 0         # samples output token #0
            else:
                out_idx[slot] = act.emitted
        return {"tables": eng.pages.tables.copy(), "pos": pos,
                "use_prompt": use_prompt, "prompt_tok": prompt_tok,
                "out_idx": out_idx, "reset": reset}
