"""Host allocator of the paged KV pool, its zero-copy prefix cache, and
the flat stream's gather.

Counterpart of ``paddle_tpu/inference/paged_kv.py``: ``BlockPool`` (the
allocator: a free list plus per-block refcounts over the one device pool
``[L, 2, NB, H, Bt, D]`` that ``FusedDecoder.init_paged_cache``
allocates; position ``s`` of slot ``b`` lives in block ``tables[b, s //
Bt]`` at offset ``s % Bt``, unmapped entries hold the sentinel
``num_blocks``); ``PagedPrefixStore`` / ``PagedPrefixCache``, the radix
store of ``prefix_cache`` pointed at that pool: a hit writes the chain's
block ids into the slot's table and takes a reference on each, a publish
takes the store's reference on the slot's own prompt blocks, so neither
copies K/V, and eviction drops only the store's reference; and
``flat_gather_view``, the dense view the plain flat attentions build on
(fp pools, and int8 pools with their scales). The COW copy and the
block transfers (``copy_block``, ``read_block``, ``write_block``) come
with ROADMAP Queue 1 item 6(f).
"""
from __future__ import annotations

import numpy as np
import torch

from .prefix_cache import PrefixNode, PrefixStore, lookup_adoptable

__all__ = ["BlockPool", "PagedPrefixStore", "PagedPrefixCache",
           "flat_gather_view"]


class BlockPool:
    def __init__(self, num_blocks, block_tokens, max_seq_len):
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self.smax = int(max_seq_len)
        if self.num_blocks < 1:
            raise ValueError("BlockPool needs num_blocks >= 1")
        bt = self.block_tokens
        if bt < 1 or bt & (bt - 1):
            raise ValueError(
                f"BlockPool block_tokens must be a power of two >= 1, "
                f"got {bt} (it is the serving engine's prefill_cap)")
        if self.smax % bt:
            # a ragged last block would index past Bt
            raise ValueError(
                f"BlockPool: max_seq_len {self.smax} must be a multiple "
                f"of block_tokens {bt} — the per-slot block table has "
                "Smax/Bt entries")
        self.refcounts = np.zeros(self.num_blocks, np.int32)
        # pop() from the end: low ids hand out first
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self.used_peak = 0

    @property
    def free_count(self):
        return len(self._free)

    @property
    def used(self):
        return self.num_blocks - len(self._free)

    def alloc(self, n=1):
        """Take ``n`` blocks (refcount 1 each); None if the free list is
        short — all or nothing."""
        if len(self._free) < int(n):
            return None
        ids = [self._free.pop() for _ in range(int(n))]
        self.refcounts[ids] = 1
        self.used_peak = max(self.used_peak, self.used)
        return ids

    def ref(self, blocks):
        for b in blocks:
            if self.refcounts[b] < 1:
                raise RuntimeError(
                    f"BlockPool.ref on free block {int(b)} — a table "
                    "entry outlived its allocation")
            self.refcounts[b] += 1

    def deref(self, blocks):
        for b in blocks:
            if self.refcounts[b] < 1:
                raise RuntimeError(
                    f"BlockPool refcount underflow on block {int(b)}")
            self.refcounts[b] -= 1
            if self.refcounts[b] == 0:
                self._free.append(int(b))

    def stats(self):
        return {"blocks_total": self.num_blocks, "blocks_used": self.used,
                "blocks_free": self.free_count}

    def gauges(self):
        return {"kv_blocks_total": self.num_blocks,
                "kv_blocks_used": self.used,
                "kv_blocks_free": self.free_count,
                "kv_blocks_used_peak": self.used_peak}


class PagedPrefixStore(PrefixStore):
    """``PrefixStore`` over the shared BlockPool: a node's ``block`` is a
    pool id on which the store holds one reference, and ``num_blocks`` is
    the store's pin budget, not a private free list. ``publish`` is
    zero-copy; eviction drops the store's reference only, so a block a
    slot still maps stays resident until that slot lets go. ``reclaim``
    evicts under pool pressure: prefix blocks are cache."""

    def __init__(self, num_blocks, block_tokens, pool):
        super().__init__(num_blocks, block_tokens)
        if pool.block_tokens != int(block_tokens):
            raise ValueError(
                f"PagedPrefixStore block_tokens={int(block_tokens)} but "
                f"the shared BlockPool has block_tokens="
                f"{pool.block_tokens} — the prefix blocks ARE pool "
                "blocks, the sizes must be ONE value")
        self.pool = pool
        self._free = []                  # no private ids
        self._pinned = 0

    def insert(self, tokens):
        raise NotImplementedError(
            "PagedPrefixStore has no private blocks to allocate — "
            "publication is zero-copy; use publish(tokens, block_ids) "
            "with the owning slot's pool block ids")

    def publish(self, tokens, block_ids):
        """Walk or extend the chain over ``tokens``' full blocks, taking
        a store reference on ``block_ids[i]`` (the owning slot's block)
        for each new node. Returns [(node, is_new), ...] root first;
        stops early when the pin budget is spent and nothing is
        evictable."""
        out = []
        node = self._root
        try:
            for i, key in enumerate(self._blocks_of(tokens)):
                if i >= len(block_ids):
                    break
                child = node.children.get(key)
                if child is None:
                    if self._pinned >= self.num_blocks:
                        victim = self._lru_evictable_leaf()
                        if victim is None:
                            break
                        self._evict(victim)
                    blk = int(block_ids[i])
                    self.pool.ref([blk])
                    self._pinned += 1
                    child = PrefixNode(key, node, blk)
                    node.children[key] = child
                    self._update_evictable(node)
                    self.committed_blocks += 1
                    out.append((child, True))
                else:
                    out.append((child, False))
                self._touch(child)
                self.acquire((child,))   # pin the chain under construction
                node = child
        finally:
            self.release(n for n, _ in out)
        return out

    def _evict(self, node):
        blk = super()._evict(node)
        self._pinned -= 1
        self.pool.deref([blk])           # the store's reference only
        return blk

    def reclaim(self, n_free):
        """Evict LRU refcount-0 leaves until the pool's free list grew by
        ``n_free`` (or nothing is evictable), store-only blocks (pool
        refcount 1) first, shared ones to unlock a parent. Returns the
        blocks freed."""
        start = self.pool.free_count
        while self.pool.free_count - start < int(n_free):
            singles = [x for x in self._evictable
                       if self.pool.refcounts[x.block] == 1]
            pickable = singles or self._evictable
            if not pickable:
                break
            self._evict(min(pickable, key=lambda x: x.last_use))
        return self.pool.free_count - start

    def stats(self):
        s = super().stats()
        # budget headroom: the pool owns the physical free list
        s["blocks_free"] = self.num_blocks - s["blocks_used"]
        return s


class PagedPrefixCache:
    """The paged twin of ``prefix_cache.PrefixCache``: ``lookup``,
    ``store``, ``block_tokens``, ``trace_count`` alike, but adopt and
    publish are index operations on the engine's block tables. One
    belongs to one engine."""

    def __init__(self, num_blocks, block_tokens, pool):
        self.store = PagedPrefixStore(num_blocks, block_tokens, pool)
        self.pool = pool
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self.trace_count = 0

    def lookup(self, tokens):
        return lookup_adoptable(self.store, self.block_tokens, tokens)

    def adopt_into(self, tables, slot, nodes):
        """The zero-copy hit: the chain's block ids into the slot's table
        row, a slot reference on each. Returns the adopted token count."""
        ids = [nd.block for nd in nodes]
        self.pool.ref(ids)
        tables[slot, :len(ids)] = ids
        return len(ids) * self.block_tokens

    def publish_from(self, tables, slot, tokens):
        """Zero-copy commit-on-prefill of ``tokens``' full blocks from the
        slot's own blocks. A block someone already published switches the
        slot's table onto the shared one and frees the private copy
        (decode never writes below plen). Returns the new blocks."""
        t = np.asarray(tokens).reshape(-1)
        nfull = t.size // self.block_tokens
        ids = [int(tables[slot, i]) for i in range(nfull)]
        if any(i >= self.pool.num_blocks for i in ids):
            raise RuntimeError(
                "publish_from before the slot's prompt blocks were "
                "mapped — prefill must land before publication")
        plan = self.store.publish(t, ids)
        new = 0
        for i, (node, is_new) in enumerate(plan):
            if is_new:
                new += 1
            elif ids[i] != node.block:
                self.pool.ref([node.block])
                self.pool.deref([ids[i]])
                tables[slot, i] = node.block
        return new


def flat_gather_view(pool_l, tbl, tslot, smax, sc_l=None):
    """Each entry of ``tslot`` (slot ids already clamped into ``tbl``)
    resolved through its block-table row into a dense [Smax]-position K/V
    row. pool_l: [2, NB, Hk, Bt, D], one layer of the pool; tbl: [B,
    Smax/Bt] int32; sc_l: optional [2, NB, Hk, 1, Bt] fp32 scales of an
    int8 pool. Returns [2, len(tslot), Hk, Smax, D] float32, dequantized
    (values times their position's scale) when sc_l is given. Unmapped
    entries clamp to block NB - 1; the caller's causal mask hides
    them."""
    nb, hk, bt, d = pool_l.shape[1:]
    tc = tbl[tslot].long().clamp(max=nb - 1)          # [T, Smax/Bt]
    kvg = pool_l[:, tc]                               # [2, T, Nblk, Hk, Bt, D]
    kvg = kvg.permute(0, 1, 3, 2, 4, 5).reshape(
        2, tslot.shape[0], hk, smax, d).float()
    if sc_l is None:
        return kvg
    return kvg * flat_gather_view(sc_l.transpose(-1, -2), tbl, tslot, smax)
