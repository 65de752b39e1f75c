"""Shared-prefix KV page pool with a refcounted radix index.

Serving workloads repeat prompt prefixes (system prompts, few-shot
headers, chat history): under decode-replay prefill, every repeated
prefix token costs one full decode step.  This module stores the KV
pages of previously-seen prefixes ONCE, in a shared pool, and lets every
later request whose prompt starts with the same tokens attend those
pages *by reference*:

* :class:`PrefixCache` is the host-side index — a radix trie keyed by
  full ``page_t``-token pages, each node owning one pool page with a
  refcount (live slot references) and an LRU tick.  Eviction reclaims
  only refcount-zero leaves, so a page shared by any active request
  can never be freed out from under it.  It is the reference's, as is.
* :class:`PrefixBlock` is the pool — ``(L, R, page_t, K, hd)`` K/V
  tensors plus per-slot page tables — carried inside
  :class:`~repro_torch.serving.kv_cache.TieredKVCache`.  The pool is ONE
  buffer in the cache's home memory (HBM on the card); its per-page
  ``page_device`` label is accounting only (billing, storage, migration
  bytes), as in the reference, where it is one physical pool too.

Sharing is exact: K rows were written with rope applied at absolute
positions, and a shared prefix occupies the same absolute positions in
every referencing request, so the cached rows are valid verbatim.  The
pool contributes one extra attention partition per decode step, merged
with the per-device partials through the same log-sum-exp combine.

Divergence *inside* a page is copy-on-write: the matched head of the
page is copied into the diverging request's own tier-placed pages and
the shared page stays immutable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

#: slot_pages sentinel: no pool page attached at this logical page.
NO_PAGE = -1
#: page_device sentinel: pool page not allocated.
UNALLOCATED = -1


@dataclasses.dataclass
class PrefixBlock:
    """Shared-prefix page pool, carried inside the KV cache.

    ``k``/``v`` are ``(L, R, page_t, K, hd)``: ``R`` pool pages of
    ``page_t`` token rows each.  ``slot_pages[b, j]`` is the pool page
    backing logical page ``j`` of slot ``b`` (``NO_PAGE`` when the slot
    owns that page privately), and ``slot_shared[b]`` the number of
    leading token positions served by references — the boundary below
    which the slot's own pool rows are sentineled out of attention.
    """

    k: torch.Tensor
    v: torch.Tensor
    slot_pages: torch.Tensor   # (B, P_max) int32
    slot_shared: torch.Tensor  # (B,) int32
    page_device: torch.Tensor  # (R,) int32; UNALLOCATED = free pool slot
    page_t: int

    @classmethod
    def create(cls, batch: int, pool_pages: int, max_pages: int,
               page_t: int, n_layers: int, n_kv_heads: int, head_dim: int,
               dtype, device) -> "PrefixBlock":
        shape = (n_layers, pool_pages, page_t, n_kv_heads, head_dim)
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            slot_pages=torch.full((batch, max_pages), NO_PAGE, **i32),
            slot_shared=torch.zeros((batch,), **i32),
            page_device=torch.full((pool_pages,), UNALLOCATED, **i32),
            page_t=page_t)

    @property
    def pool_pages(self) -> int:
        return self.k.shape[1]

    def page_bytes(self) -> int:
        L, _, pt, K, hd = self.k.shape
        return 2 * L * pt * K * hd * self.k.element_size()

    def partition(self, layer: int, valid=None):
        """(k, v, valid) attention partial over the referenced pool pages
        — one extra partition per decode step, exactly merged with the
        per-device partials.  Slots with no references contribute an
        all-invalid row, which the finite-NEG_INF merge weights to zero.
        ``valid`` may be passed in when the caller computed it for the
        step (it does not depend on the layer)."""
        R = self.k.shape[1]
        pt = self.page_t
        B, Pm = self.slot_pages.shape
        K, hd = self.k.shape[3:]
        rows = torch.clamp(self.slot_pages, 0, R - 1).reshape(-1).long()
        k = self.k[layer].index_select(0, rows).reshape(B, Pm * pt, K, hd)
        v = self.v[layer].index_select(0, rows).reshape(B, Pm * pt, K, hd)
        if valid is None:
            valid = self.valid()
        return k, v, valid

    def valid(self) -> torch.Tensor:
        return torch.repeat_interleave(self.slot_pages >= 0, self.page_t,
                                       dim=1)


class _Node:
    """One trie node == one pool page holding one full token page."""

    __slots__ = ("page", "refcount", "tick", "children", "parent", "key")

    def __init__(self, page: int, parent: dict, key: tuple, tick: int):
        self.page = page
        self.refcount = 0
        self.tick = tick
        self.children: dict[tuple, "_Node"] = {}
        self.parent = parent  # the children-dict this node lives in
        self.key = key

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"_Node(page={self.page}, rc={self.refcount}, "
                f"children={len(self.children)})")


class PrefixCache:
    """Host-side radix index over full ``page_t``-token prompt pages.

    Pure bookkeeping: allocation, matching, refcounts, LRU eviction.
    The KV bytes live in the :class:`PrefixBlock`; callers copy rows in
    and out of the pool through the TieredKVCache helpers.
    """

    def __init__(self, pool_pages: int, page_t: int):
        self.page_t = int(page_t)
        self.pool_pages = int(pool_pages)
        self.root: dict[tuple, _Node] = {}
        self._free = list(range(pool_pages - 1, -1, -1))
        self._tick = 0
        self.nodes: dict[int, _Node] = {}  # pool page -> node
        # observability
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.cow_copies = 0

    # -- lookup ----------------------------------------------------------------
    def _page_key(self, prompt: Sequence[int], p: int) -> tuple:
        pt = self.page_t
        return tuple(int(t) for t in prompt[p * pt:(p + 1) * pt])

    def match(self, prompt: Sequence[int]
              ) -> tuple[list[_Node], Optional[_Node], int]:
        """Longest shared prefix of ``prompt`` in the index.

        Returns ``(nodes, partial, partial_len)``: ``nodes`` are the
        fully-matched page nodes (coverage capped at ``len(prompt) - 1``
        tokens — the last prompt token always replays so decode has a
        current-token activation), and ``partial`` the child whose page
        shares ``partial_len`` leading tokens with the remainder — the
        copy-on-write divergence point."""
        pt = self.page_t
        limit = max(len(prompt) - 1, 0) // pt
        children = self.root
        nodes: list[_Node] = []
        for p in range(limit):
            node = children.get(self._page_key(prompt, p))
            if node is None:
                break
            nodes.append(node)
            children = node.children
        rest = [int(t) for t in prompt[len(nodes) * pt: len(prompt) - 1]]
        partial, plen = None, 0
        if rest:
            for key, node in children.items():
                n = 0
                for a, b in zip(key, rest):
                    if a != b:
                        break
                    n += 1
                if n > plen:
                    partial, plen = node, n
        if nodes or plen:
            self.hits += 1
        else:
            self.misses += 1
        return nodes, partial, plen

    # -- reference management ---------------------------------------------------
    def touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def acquire(self, nodes: Sequence[_Node]) -> None:
        for n in nodes:
            n.refcount += 1
            self.touch(n)

    def release(self, nodes: Sequence[_Node]) -> None:
        for n in nodes:
            assert n.refcount > 0, "release without matching acquire"
            n.refcount -= 1

    # -- insertion / eviction ---------------------------------------------------
    def _alloc(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        # LRU-evict: only refcount-zero LEAVES are reclaimable — a page
        # referenced by a live slot (or holding a live subtree) survives.
        victim = min((n for n in self.nodes.values()
                      if n.refcount == 0 and not n.children),
                     key=lambda n: n.tick, default=None)
        if victim is None:
            return None
        assert victim.refcount == 0, "evicting a referenced prefix page"
        del victim.parent[victim.key]
        del self.nodes[victim.page]
        self.evictions += 1
        return victim.page

    def insert(self, prompt: Sequence[int], matched: Sequence[_Node]
               ) -> list[tuple[int, _Node]]:
        """Extend the trie path ``matched`` with ``prompt``'s remaining
        full pages.  Returns ``[(page_no, node)]`` placements whose pool
        pages the caller must fill; stops early when the pool is
        exhausted of reclaimable pages."""
        pt = self.page_t
        limit = max(len(prompt) - 1, 0) // pt
        children = matched[-1].children if matched else self.root
        placed: list[tuple[int, _Node]] = []
        for p in range(len(matched), limit):
            key = self._page_key(prompt, p)
            node = children.get(key)
            if node is None:
                slot = self._alloc()
                if slot is None:
                    break
                self._tick += 1
                node = _Node(slot, children, key, self._tick)
                children[key] = node
                self.nodes[slot] = node
                placed.append((p, node))
            self.touch(node)
            children = node.children
        return placed

    # -- accounting -------------------------------------------------------------
    def page_refcounts(self) -> dict[int, int]:
        return {page: n.refcount for page, n in self.nodes.items()}

    def allocated_pages(self) -> int:
        return len(self.nodes)

    def dedup_pages(self) -> int:
        """Pool pages' worth of storage saved by sharing right now: each
        reference beyond storing the page once is a page the baseline
        would have materialized privately."""
        return sum(max(n.refcount - 1, 0) for n in self.nodes.values())
