"""KV caches. Counterpart of ``repro.models.cache``.

Contiguous cache (the whole-batch ``serve.engine.DecodeEngine``): each
attention layer keeps ``k``/``v`` of shape (B, C, Hkv, D), stacked along
a leading layer axis, with C = min(seq_len, window): a ring buffer under
a sliding window. :func:`cache_positions` gives the global position each
ring slot holds (-1 for a slot never written, which the attention mask
hides). The decode position ``pos`` (tokens consumed so far) is a 0-dim
int32 tensor on the cache's device, so a step reads nothing back to the
host. Recurrent layers keep constant-size states beside it.

Paged cache (serving tier): the serving engine keeps K/V in a PAGE POOL
of shape (L, n_pages, page_size, Hkv, D) plus a per-sequence block
table (table_width,) of physical page indices. The table is a logical
ring at page granularity: slot j of a sequence at logical page m holds
the largest page m' <= m with m' % table_width == j, so sliding-window
eviction is ring reuse (overwrite in place) and the table width is
fixed. Physical page 0 is
the TRASH page: inactive batch slots write and read it and are masked
out by their sequence length.
"""
from __future__ import annotations

import torch


def attn_cache_len(seq_len: int, window) -> int:
    return seq_len if window is None else min(seq_len, window)


def init_attn_cache(n_layers, batch, cache_len, n_kv, head_dim, dtype,
                    device=None):
    """Zeroed contiguous K/V: {"k", "v"} of (n_layers, batch, cache_len,
    n_kv, head_dim)."""
    shape = (n_layers, batch, cache_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def update_attn_cache(layer_cache, k_new, v_new, pos):
    """Write one token's K/V at ring slot ``pos % C``, in place (JAX:
    a donated buffer). layer_cache: {"k", "v"} (B, C, Hkv, D); k_new:
    (B, 1, Hkv, D); pos: 0-dim int tensor. Returns the layer cache."""
    C = layer_cache["k"].shape[1]
    slot = torch.remainder(pos, C).reshape(1).long()
    layer_cache["k"].index_copy_(1, slot, k_new.to(layer_cache["k"].dtype))
    layer_cache["v"].index_copy_(1, slot, v_new.to(layer_cache["v"].dtype))
    return layer_cache


def cache_positions(cache_len: int, pos):
    """Global position held by each ring slot after ``pos+1`` writes.

    Slot s holds the largest position p <= pos with p % C == s; slots never
    written yet get -1 (masked). ``pos``: 0-dim int tensor -> (C,)."""
    slots = torch.arange(cache_len, device=pos.device)
    rem = torch.remainder(pos, cache_len)
    p = torch.where(slots <= rem, pos - rem + slots,
                    pos - rem + slots - cache_len)
    return torch.where(p >= 0, p, torch.full_like(p, -1))


# ------------------------------------------------------------------
# paged KV cache (serving tier)
# ------------------------------------------------------------------

#: physical page index reserved for masked writes of inactive slots
TRASH_PAGE = 0


def paged_table_width(max_seq: int, window, page_size: int) -> int:
    """Block-table slots needed so ring reuse never evicts a live key:
    positions (pos-W, pos] span at most ceil(W/ps)+1 pages."""
    n_total = -(-max_seq // page_size)
    if window is None:
        return n_total
    return min(n_total, -(-window // page_size) + 1)


def paged_slot_pages(table_width: int, cur_page):
    """Logical page held by each table slot when the sequence is at
    logical page ``cur_page`` (= pos // page_size). -1 = never written.
    ``cur_page``: (...,) int tensor -> (..., table_width)."""
    cur = cur_page[..., None]
    slots = torch.arange(table_width, device=cur.device)
    rem = torch.remainder(cur, table_width)      # floor mod, as jnp.mod
    p = torch.where(slots <= rem, cur - rem + slots,
                    cur - rem + slots - table_width)
    return torch.where(p >= 0, p, torch.full_like(p, -1))


def init_paged_pool(n_layers, n_pages, page_size, n_kv, head_dim, dtype,
                    device=None):
    """One spec's page pool; physical page indices are shared across the
    stacked layers (index [l, page] addresses layer l's copy)."""
    shape = (n_layers, n_pages, page_size, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_phys_pages(tables, pos_b, page_size: int):
    """Physical page + in-page slot for writing position ``pos_b``.

    tables: (B, TW) int; pos_b: (B,). Returns (phys (B,), slot (B,)).
    """
    TW = tables.shape[1]
    tj = torch.remainder(torch.div(pos_b, page_size, rounding_mode="floor"),
                         TW)
    phys = torch.gather(tables, 1, tj[:, None].long())[:, 0]
    return phys, torch.remainder(pos_b, page_size)
