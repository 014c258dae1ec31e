"""Paged KV cache (serving tier). Counterpart of the paged part of
``repro.models.cache``; the contiguous ring cache is not ported yet.

The serving engine keeps K/V in a PAGE POOL of shape (L, n_pages,
page_size, Hkv, D) plus a per-sequence block table (table_width,) of
physical page indices. The table is a logical ring at page granularity:
slot j of a sequence at logical page m holds the largest page m' <= m
with m' % table_width == j, so sliding-window eviction is ring reuse
(overwrite in place) and the table width is fixed. Physical page 0 is
the TRASH page: inactive batch slots write and read it and are masked
out by their sequence length.
"""
from __future__ import annotations

import torch

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
