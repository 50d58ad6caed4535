"""Prefix sharing: a rolling token-hash trie over pool pages.

Counterpart of :mod:`apex_tpu.inference.prefix`, a copy of its
host-side Python over this package's
:class:`~apex_tpu_torch.inference.kv_cache.PageAllocator`.  N requests
carrying the same system prompt hold ONE physical copy of its KV pages:
a trie keyed by a rolling hash of page-sized token blocks, each node
owning (one reference on) the pool page that caches exactly that
block's k/v.  Admission matches a new prompt's longest full-page chain
and maps the matched pages straight into the sequence's page table via
:meth:`PageAllocator.share`; the pages are never rewritten
(``write_prompt_kv(start=shared_len)`` masks them out of the prefill
write), and chunked prefill skips their compute.

**Why the values are interchangeable**: a layer's k/v at position ``i``
depend only on tokens ``0..i`` (causal) and the weights, so two prompts
agreeing on their first ``shared_len`` tokens produce the same k/v
there: sharing the pages is the unshared computation, minus the copies.

**Tail pages and copy-on-write**: a node may also index its chain's
final PARTIAL page (``tail``).  A new prompt whose remainder is a
prefix of the cached tail's tokens shares that page too, but the tail
sits in the write path (the first generated token's k/v lands in it),
so tail sharing never reduces the reservation: the admitting sequence
still reserves one fresh page as its COW budget, and the scheduler
copies the page (:func:`apex_tpu_torch.inference.kv_cache.copy_page`)
before the first divergent write.  Full pages live strictly below
every write position and never need COW, which is what lets them
reduce the reservation and admit more sequences than worst-case
accounting.

The trie holds its OWN reference on every indexed page, so cached
prefixes survive their registering sequence's eviction; under pool
pressure the scheduler calls :meth:`PrefixCache.release` to drop
least-recently-used root chains until enough pages actually RECYCLE
(chains whose every page is still resident-held are skipped).
"""

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.inference.kv_cache import GARBAGE_PAGE, PageAllocator

__all__ = ["PrefixCache", "PrefixMatch"]

_HASH_SEED = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def _roll(parent: int, block: Tuple[int, ...]) -> int:
    """Rolling hash of one page-sized token block chained onto its
    parent's key (splitmix-style mixing; collisions are verified
    against the stored tokens, never trusted)."""
    h = parent
    for t in block:
        h = (h ^ (int(t) + _HASH_SEED + ((h << 12) & _MASK64)
                  + (h >> 4))) & _MASK64
        h = (h * 0x100000001B3) & _MASK64
    return h


@dataclasses.dataclass
class _Node:
    page: int
    tokens: Tuple[int, ...]
    children: Dict[int, "_Node"] = dataclasses.field(default_factory=dict)
    tail_page: Optional[int] = None
    tail_tokens: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """An admission plan's sharing component: ``full_pages`` — pool
    pages covering the prompt's leading full page blocks, in order;
    ``tail_page`` — the shared partial page covering the remainder (or
    None); ``shared_len`` — prompt positions covered in total (k/v
    already pooled; prefill starts writing — and chunked prefill
    starts computing — here)."""

    full_pages: Tuple[int, ...]
    tail_page: Optional[int]
    shared_len: int

    @property
    def num_full(self) -> int:
        return len(self.full_pages)


_NO_MATCH = PrefixMatch(full_pages=(), tail_page=None, shared_len=0)


class PrefixCache:
    """The rolling token-hash trie (see module doc).  Owned by the
    scheduler; every indexed page carries one trie reference in the
    shared :class:`PageAllocator`."""

    def __init__(self, allocator: PageAllocator, page_size: int):
        self._alloc = allocator
        self._ps = int(page_size)
        self._roots: Dict[int, _Node] = {}
        #: root key -> LRU stamp (bumped on any match/register through it)
        self._used: Dict[int, int] = {}
        self._clock = 0
        self.stats = {"hits": 0, "misses": 0, "released_pages": 0}

    @property
    def indexed_pages(self) -> int:
        """Pages the trie currently holds a reference on."""
        return sum(self._chain_pages(n) for n in self._roots.values())

    def _chain_pages(self, node: _Node) -> int:
        n = 1 + (1 if node.tail_page is not None else 0)
        return n + sum(self._chain_pages(c) for c in node.children.values())

    def _walk(self, prompt: Sequence[int]):
        """Longest verified chain: yields (key, node) per matched full
        page block."""
        ps = self._ps
        h = _HASH_SEED
        level, node = self._roots, None
        for i in range(len(prompt) // ps):
            block = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            h = _roll(h, block)
            child = level.get(h)
            if child is None or child.tokens != block:
                return  # hash miss, or a collision — treat as miss
            node = child
            yield h, node
            level = node.children

    def match(self, prompt: Sequence[int]) -> PrefixMatch:
        """The longest shareable prefix of ``prompt`` — does NOT take
        references; the scheduler shares exactly what it admits."""
        chain = list(self._walk(prompt))
        if not chain:
            self.stats["misses"] += 1
            return _NO_MATCH
        self._clock += 1
        self._used[chain[0][0]] = self._clock
        self.stats["hits"] += 1
        node = chain[-1][1]
        pages = tuple(n.page for _, n in chain)
        rest = tuple(int(t) for t in prompt[len(pages) * self._ps:])
        # tail share only when the remainder is FULLY covered by the
        # cached tail's tokens: a mid-page divergence would COW at
        # admission, saving nothing
        if rest and node.tail_page is not None \
                and len(rest) <= len(node.tail_tokens) \
                and node.tail_tokens[:len(rest)] == rest:
            return PrefixMatch(full_pages=pages, tail_page=node.tail_page,
                               shared_len=len(pages) * self._ps + len(rest))
        return PrefixMatch(full_pages=pages, tail_page=None,
                           shared_len=len(pages) * self._ps)

    def register(self, prompt: Sequence[int],
                 table_pages: Sequence[int], tail: bool = False) -> int:
        """Index an admitted prompt's pages (call AFTER its prefill
        writes land): every full page block gets a trie node; with
        ``tail=True`` the partial remainder's page becomes the chain's
        tail — only safe once that page is QUIESCED (the owning
        sequence evicted: generation writes into the tail page, so a
        live owner would mutate a trie page).  ``table_pages`` is the
        sequence's page-table prefix in order (shared entries included
        — already-indexed blocks are left untouched).  Returns the net
        number of newly indexed pages (each +1 ref)."""
        ps = self._ps
        added = 0
        h = _HASH_SEED
        level, node = self._roots, None
        root_key = None
        for i in range(len(prompt) // ps):
            block = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            h = _roll(h, block)
            root_key = h if root_key is None else root_key
            child = level.get(h)
            if child is not None and child.tokens != block:
                break  # collision slot — leave the incumbent alone
            if child is None:
                page = int(table_pages[i])
                if page == GARBAGE_PAGE:
                    break  # table shorter than the prompt? stop clean
                child = _Node(page=page, tokens=block)
                self._alloc.share([page])
                level[h] = child
                added += 1
            node, level = child, child.children
        if root_key is not None:
            self._clock += 1
            self._used[root_key] = self._clock
        rest = tuple(int(t) for t in prompt[(len(prompt) // ps) * ps:])
        if tail and node is not None and rest \
                and len(rest) > len(node.tail_tokens):
            page = int(table_pages[len(prompt) // ps])
            if page != GARBAGE_PAGE and page != node.tail_page:
                if node.tail_page is not None:
                    self._alloc.free([node.tail_page])
                    added -= 1
                self._alloc.share([page])
                node.tail_page = page
                node.tail_tokens = rest
                added += 1
        return added

    def release(self, n_pages: int) -> int:
        """Drop least-recently-used ROOT chains until >= ``n_pages``
        pages are actually RECYCLED to the free list (or no droppable
        chain remains).  Chains whose every page is still resident-held
        are skipped entirely: dropping them would free nothing while
        destroying the sharing the residents came from — the one thing
        a pressure-relief pass must never make worse.  Returns pages
        recycled (0 = releasing cannot help; the caller escalates to
        preemption)."""
        freed = 0
        order = sorted(self._roots, key=lambda k: self._used.get(k, 0))
        for key in order:
            if freed >= n_pages:
                break
            if self._recyclable(self._roots[key]) == 0:
                continue  # all pages resident-held — keep the chain
            freed += self._drop(self._roots.pop(key))
            self._used.pop(key, None)
        self.stats["released_pages"] += freed
        return freed

    def _recyclable(self, node: _Node) -> int:
        """Pages in this chain the trie is the LAST holder of — the
        ones :meth:`release` would actually return to the free list."""
        n = 1 if self._alloc.refcount(node.page) == 1 else 0
        if node.tail_page is not None \
                and self._alloc.refcount(node.tail_page) == 1:
            n += 1
        return n + sum(self._recyclable(c)
                       for c in node.children.values())

    def _drop(self, node: _Node) -> int:
        """Decref every page in the chain; count only those whose LAST
        reference this was (they recycled — resident-held pages stay
        alive, they just stop being shareable)."""
        n = 0
        for child in node.children.values():
            n += self._drop(child)
        if node.tail_page is not None:
            if self._alloc.refcount(node.tail_page) == 1:
                n += 1
            self._alloc.free([node.tail_page])
        if self._alloc.refcount(node.page) == 1:
            n += 1
        self._alloc.free([node.page])
        return n
