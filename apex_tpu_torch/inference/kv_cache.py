"""Paged KV cache: fixed-size pages in a preallocated pool.

Counterpart of :mod:`apex_tpu.inference.kv_cache`, with its semantics:
the KV cache of every resident sequence lives in one pool per layer,
``(num_layers, num_pages, page_size, kv_heads, head_dim)`` for each of
k and v, and every sequence owns a fixed-width page table mapping its
positions ``[p * page_size, (p + 1) * page_size)`` onto pool pages.

Page 0 is the garbage page: :class:`PageAllocator` never hands it out,
and every masked write (inactive slot, padded prompt tail) goes there
instead of being skipped, so a write never touches a live sequence's
page.  Every page-table read is clamped into the pool.

The pools are updated IN PLACE (``index_put_``): the JAX package
donates them through its jitted steps and rebinds them; here the
tensors the caller holds are the ones written.  The allocator is
host-side bookkeeping, a copy of the JAX package's (this package
imports nothing from it).
"""

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from apex_tpu_torch._device import resolve_device

__all__ = [
    "GARBAGE_PAGE", "KVCacheConfig", "PageAllocator", "alloc_pools",
    "copy_page", "decode_write_index", "pages_needed", "write_decode_kv",
    "write_prompt_kv",
]

#: page id 0 — reserved, never allocated; the destination of every
#: masked (inactive / padded) cache write
GARBAGE_PAGE = 0


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Shape of the pool.  ``num_pages`` includes the garbage page, so
    ``num_pages - 1`` pages are usable; ``pages_per_seq`` is the page
    table's width, so the longest sequence is ``pages_per_seq *
    page_size`` positions."""

    num_pages: int = 128
    page_size: int = 16
    pages_per_seq: int = 16
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2: page 0 is the "
                             "reserved garbage page")
        if self.page_size < 1 or self.pages_per_seq < 1:
            raise ValueError("page_size and pages_per_seq must be >= 1")

    @property
    def max_len(self) -> int:
        return self.pages_per_seq * self.page_size


def pages_needed(total_positions: int, page_size: int) -> int:
    """Pages to reserve for a sequence that will cache
    ``total_positions`` tokens (admission reserves the worst case)."""
    return -(-int(total_positions) // int(page_size))


def alloc_pools(num_layers: int, kv_heads: int, head_dim: int,
                cfg: KVCacheConfig, device="cuda") -> Dict[str, torch.Tensor]:
    """Zero-initialized k/v pools, ``(L, num_pages, page_size, kv_heads,
    head_dim)`` each, in the storage dtype on ``device``."""
    dev = resolve_device(device)
    shape = (num_layers, cfg.num_pages, cfg.page_size, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


class PageAllocator:
    """Host-side refcounted free list over the pool's pages (page 0
    reserved), FIFO recycling: freed pages go to the back of the list.

    :meth:`allocate` hands pages out at refcount 1, :meth:`share` takes
    an extra reference on a live page and :meth:`free` drops one,
    recycling the page when the count reaches zero.  The garbage page
    can be neither allocated, shared nor freed."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 reserved)")
        self.num_pages = int(num_pages)
        self._free = deque(range(1, self.num_pages))
        self._refs: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Pages currently allocated (refcount >= 1)."""
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def allocate(self, n: int) -> Optional[List[int]]:
        """``n`` pages at refcount 1 each, or None (never a partial
        grab) when the pool cannot cover the request."""
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages) -> None:
        """One extra reference on each (live) page."""
        for p in pages:
            p = int(p)
            if p == GARBAGE_PAGE:
                raise ValueError("page 0 is reserved and never shared")
            if p not in self._refs:
                raise ValueError(f"share of free page {p} — only live "
                                 f"(allocated) pages can gain references")
            self._refs[p] += 1

    def free(self, pages) -> None:
        """Drop one reference per page; the last one recycles it."""
        for p in pages:
            p = int(p)
            if p == GARBAGE_PAGE:
                raise ValueError("page 0 is reserved and never allocated")
            if not (0 < p < self.num_pages):
                raise ValueError(f"page id {p} outside pool "
                                 f"[1, {self.num_pages})")
            if p not in self._refs:
                raise ValueError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)


# ----------------------------------------------------------- device writes
def copy_page(pools, src: int, dst: int):
    """Copy pool page ``src`` into ``dst`` across every layer of both
    pools, in place; returns the pools.  Neither may be the garbage
    page."""
    src, dst = int(src), int(dst)
    num_pages = pools["k"].shape[1]
    for p in (src, dst):
        if not (GARBAGE_PAGE < p < num_pages):
            raise ValueError(
                f"copy_page({src}, {dst}): page {p} outside the "
                f"allocatable pool (1, {num_pages})")
    if src == dst:
        raise ValueError(f"copy_page: src == dst == {src}")
    for name in ("k", "v"):
        pools[name][:, dst] = pools[name][:, src]
    return pools


def decode_write_index(page_tables, positions, active, num_pages: int,
                       page_size: int):
    """``(page, slot)`` index tensors (B,) for one decode step's cache
    writes: the page each row's position falls in, read from its
    (clamped) table row; inactive rows go to the garbage page, slot 0.
    The same for every layer, so a step computes it once."""
    P = page_tables.shape[1]
    positions = positions.long()
    page_ix = (positions // page_size).clamp(0, P - 1)
    rows = page_tables.long().gather(1, page_ix[:, None])[:, 0]
    dest = torch.where(active, rows.clamp(0, num_pages - 1), GARBAGE_PAGE)
    slot = torch.where(active, positions % page_size, 0)
    return dest, slot


def write_decode_kv(k_pool, v_pool, k_new, v_new, page_tables, positions,
                    active):
    """Write one decode step's k/v into a layer's pools, in place.

    ``k_pool``/``v_pool``: (num_pages, page_size, H_kv, D); ``k_new``/
    ``v_new``: (B, H_kv, D); ``page_tables``: (B, P); ``positions``:
    (B,); ``active``: (B,) bool write mask (inactive rows write the
    garbage page).  Returns the pools."""
    dest, slot = decode_write_index(page_tables, positions, active,
                                    k_pool.shape[0], k_pool.shape[1])
    k_pool.index_put_((dest, slot), k_new.to(k_pool.dtype))
    v_pool.index_put_((dest, slot), v_new.to(v_pool.dtype))
    return k_pool, v_pool


def write_prompt_kv(k_pool, v_pool, k_stack, v_stack, page_table_row,
                    prompt_len, start=0):
    """Write a prefilled prompt's k/v into all layers' pools, in place.

    ``k_pool``/``v_pool``: (L, num_pages, page_size, H_kv, D);
    ``k_stack``/``v_stack``: (L, S, H_kv, D), the forward's post-RoPE
    keys/values for the padded prompt; ``page_table_row``: (P,).
    Positions >= ``prompt_len`` (the pad tail) and < ``start`` (a
    prefix already cached in shared pages) write the garbage page.
    Returns the pools."""
    num_pages, page_size = k_pool.shape[1], k_pool.shape[2]
    P = page_table_row.shape[0]
    S = k_stack.shape[1]
    s = torch.arange(S, device=k_pool.device)
    page_ix = (s // page_size).clamp(0, P - 1)
    rows = page_table_row.long()[page_ix]
    valid = (s >= start) & (s < prompt_len)
    dest = torch.where(valid, rows.clamp(0, num_pages - 1), GARBAGE_PAGE)
    slot = torch.where(valid, s % page_size, 0)
    k_pool[:, dest, slot] = k_stack.to(k_pool.dtype)
    v_pool[:, dest, slot] = v_stack.to(v_pool.dtype)
    return k_pool, v_pool
