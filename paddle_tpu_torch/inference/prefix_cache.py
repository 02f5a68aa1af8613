"""Automatic prefix caching over the dense KV ring.

Counterpart of ``paddle_tpu/inference/prefix_cache.py``: a cached prompt
prefix is data — its K/V blocks are copied into a slot's ring row instead
of being recomputed by prefill. Two halves:

- ``PrefixStore``: a host radix tree over chunk-aligned token blocks
  (a block is ``block_tokens`` tokens: the serving engine's
  ``prefill_cap``). Each node owns one pool block and is keyed by that
  block's exact token tuple under its parent. Refcounts pin a chain while
  it is copied; eviction takes the least recently used refcount-0 leaf
  (an inner node's children are reachable only through it). numpy only.
- ``PrefixCache``: the store plus a block pool ``{"kv": [L, 2, NB, H,
  Bt, D](, "sc": [L, 2, NB, H, 1, Bt])}`` on the ring's device (int8 with
  fp32 scales under ``kv_quant="int8"``), and the two copies: ``adopt``
  writes a matched chain into a slot's ring row at positions [0, n *
  Bt), ``commit_block`` copies one full block of a slot's row into the
  pool. Both are plain torch indexing (JAX's are XLA gathers and
  scatters, no kernel either). A slot copies in at admission and out at
  commit; decode writes only slot-private positions, so a published
  block is never mutated.

One ``PrefixCache`` can serve a dense ``ServingEngine`` and
``FusedDecoder.generate(prefix_cache=...)`` alike: the pool depends on
(L, H, D, the cache flavor) only. The paged engine's zero-copy twin,
``paged_kv.PagedPrefixCache``, reuses ``PrefixStore`` over the engine's
own block pool.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PrefixStore", "PrefixCache", "PrefixNode",
           "lookup_adoptable"]


def lookup_adoptable(store, block_tokens, tokens):
    """The longest adoptable chain for a prompt, shared by the dense and
    the paged cache: the radix match capped so that at least one prompt
    token goes through prefill (the first token's sample needs the last
    prompt token's hidden state), and the store's hit / miss counters
    bumped after the cap."""
    t = np.asarray(tokens).reshape(-1)
    nodes = store.match(t)
    nodes = nodes[:(t.size - 1) // block_tokens]
    if nodes:
        store.match_hits += 1
    else:
        store.match_misses += 1
    return nodes


class PrefixNode:
    """One radix-tree node, one published KV block: ``tokens`` is the
    block's token tuple (the edge from ``parent``), ``block`` its pool
    index."""

    __slots__ = ("tokens", "parent", "children", "block", "refcount",
                 "last_use")

    def __init__(self, tokens, parent, block):
        self.tokens = tokens
        self.parent = parent
        self.children = {}               # token tuple -> PrefixNode
        self.block = block
        self.refcount = 0
        self.last_use = 0

    def __repr__(self):
        return (f"PrefixNode(block={self.block}, ref={self.refcount}, "
                f"children={len(self.children)})")


class PrefixStore:
    """Host radix store over fixed-size token blocks: a budget of
    ``num_blocks`` pool blocks, refcounts, and LRU leaf eviction."""

    def __init__(self, num_blocks, block_tokens):
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        if self.num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if self.block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        self._root = PrefixNode((), None, -1)
        self._free = list(range(self.num_blocks))
        # refcount-0 leaves, kept at every transition, so eviction picks
        # the oldest without walking the tree
        self._evictable = set()
        self._tick = 0
        self.match_hits = 0
        self.match_misses = 0
        self.evictions = 0
        self.committed_blocks = 0

    def _blocks_of(self, tokens):
        """The full ``block_tokens``-sized tuples of ``tokens`` (a ragged
        tail forms no block)."""
        t = np.asarray(tokens).reshape(-1)
        bt = self.block_tokens
        return [tuple(int(x) for x in t[i * bt:(i + 1) * bt])
                for i in range(t.size // bt)]

    def _touch(self, node):
        self._tick += 1
        node.last_use = self._tick

    def match(self, tokens):
        """The longest chain of published blocks prefixing ``tokens``,
        root first; each matched node's LRU stamp moves. Takes no refs
        and counts nothing (``lookup_adoptable`` counts after its cap)."""
        chain = []
        node = self._root
        for key in self._blocks_of(tokens):
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            chain.append(child)
            node = child
        return chain

    def _update_evictable(self, node):
        if node is self._root:
            return
        if node.children or node.refcount:
            self._evictable.discard(node)
        else:
            self._evictable.add(node)

    def acquire(self, nodes):
        for n in nodes:
            n.refcount += 1
            self._evictable.discard(n)

    def release(self, nodes):
        for n in nodes:
            if n.refcount <= 0:
                raise RuntimeError("prefix block refcount underflow")
            n.refcount -= 1
            self._update_evictable(n)

    def insert(self, tokens):
        """Publish ``tokens``' full blocks: walk or extend the chain,
        allocating a pool block (evicting cold ones when the budget is
        spent) for each node that does not exist yet. Returns [(node,
        is_new), ...] root first; the caller copies the K/V of every new
        block. Stops early when no block can be had (a partial chain is
        valid: matching is per block)."""
        out = []
        node = self._root
        try:
            for key in self._blocks_of(tokens):
                child = node.children.get(key)
                if child is None:
                    blk = self._alloc()
                    if blk is None:
                        break
                    child = PrefixNode(key, node, blk)
                    node.children[key] = child
                    self._update_evictable(node)
                    self.committed_blocks += 1
                    out.append((child, True))
                else:
                    out.append((child, False))
                self._touch(child)
                # pin the chain under construction, so a chain longer
                # than the free budget cannot evict its own fresh tail
                self.acquire((child,))
                node = child
        finally:
            self.release(n for n, _ in out)
        return out

    def _alloc(self):
        if self._free:
            return self._free.pop()
        victim = self._lru_evictable_leaf()
        if victim is None:
            return None
        return self._evict(victim)

    def _lru_evictable_leaf(self):
        return min(self._evictable, key=lambda n: n.last_use,
                   default=None)

    def _evict(self, node):
        """Unlink a refcount-0 leaf and recycle its block id."""
        if node.children or node.refcount:
            raise RuntimeError("evicting a pinned or inner prefix block")
        del node.parent.children[node.tokens]
        self._evictable.discard(node)
        self._update_evictable(node.parent)
        self.evictions += 1
        return node.block

    def _count_nodes(self):
        n, stack = 0, list(self._root.children.values())
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n

    def stats(self):
        # blocks_free is the real free list, so a leaked id shows as
        # used + free != capacity
        return {
            "blocks_capacity": self.num_blocks,
            "blocks_used": self._count_nodes(),
            "blocks_free": len(self._free),
            "match_hits": self.match_hits,
            "match_misses": self.match_misses,
            "evictions": self.evictions,
            "committed_blocks": self.committed_blocks,
        }


def _ring(caches):
    """A ring as the step pieces' dict: ``FusedDecoder.init_cache``'s
    tensor or (int8, scales) pair, or the dict itself."""
    if isinstance(caches, dict):
        return caches
    if isinstance(caches, tuple):
        return {"kv": caches[0], "sc": caches[1]}
    return {"kv": caches}


class PrefixCache:
    """The device half: the block pool, ``adopt`` and ``commit_block``.
    Shareable between a dense ServingEngine and ``generate`` calls on one
    device and one cache flavor. ``trace_count`` stays 0: the copies are
    eager."""

    def __init__(self, num_blocks, block_tokens):
        self.store = PrefixStore(num_blocks, block_tokens)
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self._pool = None                # {"kv"(, "sc")} on the device
        self._pool_sig = None            # (L, H, D, dtype, int8?)
        self.trace_count = 0

    @staticmethod
    def _sig_of(caches):
        c = _ring(caches)
        L, _, _, H, _, D = c["kv"].shape
        return (L, H, D, str(c["kv"].dtype), "sc" in c)

    def _ensure_pool(self, caches):
        """Build the pool for this ring's layout, or check that it is the
        one built: [L, 2, NB, H, Bt, D] (+ scales [L, 2, NB, H, 1, Bt]),
        the block index on the ring's batch axis."""
        sig = self._sig_of(caches)
        if self._pool is not None:
            if sig != self._pool_sig:
                raise ValueError(
                    f"prefix cache pool was built for {self._pool_sig}, "
                    f"got caches with {sig} — one PrefixCache serves one "
                    "model/cache flavor")
            return
        c = _ring(caches)
        L, H, D, _, quant = sig
        shape = (L, 2, self.num_blocks, H, self.block_tokens, D)
        dev = c["kv"].device
        self._pool = {"kv": torch.zeros(shape, dtype=c["kv"].dtype,
                                        device=dev)}
        if quant:
            self._pool["sc"] = torch.zeros(
                shape[:4] + (1, self.block_tokens), dtype=torch.float32,
                device=dev)
        self._pool_sig = sig

    def lookup(self, tokens):
        """The longest adoptable chain (``lookup_adoptable``)."""
        return lookup_adoptable(self.store, self.block_tokens, tokens)

    def adopt(self, caches, slot, nodes):
        """Write ``nodes``' pool blocks into the ring's row ``slot`` at
        positions [0, len(nodes) * Bt), in place. As JAX's, the chain is
        gathered over a pow-2 ladder of K blocks whose tail positions
        (>= n * Bt) are dropped; every landed position is < plen. Returns
        ``caches``. The caller holds refs on ``nodes`` across the call."""
        self._ensure_pool(caches)
        n = len(nodes)
        if n == 0:
            return caches
        c, bt = _ring(caches), self.block_tokens
        k = 1 << (n - 1).bit_length()
        idx = np.zeros(k, np.int64)
        idx[:n] = [nd.block for nd in nodes]
        idx = torch.from_numpy(idx).to(c["kv"].device)
        keep = n * bt
        blocks = self._pool["kv"][:, :, idx]           # [L, 2, K, H, Bt, D]
        vals = blocks.permute(0, 1, 3, 2, 4, 5).flatten(3, 4)
        c["kv"][:, :, slot, :, :keep] = vals[:, :, :, :keep]
        if "sc" in c:
            scs = self._pool["sc"][:, :, idx]          # [L, 2, K, H, 1, Bt]
            sv = scs.permute(0, 1, 3, 4, 2, 5).flatten(4, 5)
            c["sc"][:, :, slot, :, :, :keep] = sv[..., :keep]
        return caches

    def commit_block(self, caches, slot, t0, dst_block):
        """Copy the Bt-position block at ring row ``slot``, positions [t0,
        t0 + Bt), into pool block ``dst_block`` (with its scales). Called
        after the block's prefill landed."""
        self._ensure_pool(caches)
        c, bt, t0 = _ring(caches), self.block_tokens, int(t0)
        pool = self._pool
        pool["kv"][:, :, dst_block] = c["kv"][:, :, slot, :, t0:t0 + bt]
        if "sc" in c:
            pool["sc"][:, :, dst_block] = c["sc"][:, :, slot, :, :,
                                                  t0:t0 + bt]

    def publish(self, caches, slot, tokens):
        """Commit-on-prefill: publish each full block of ``tokens`` not
        yet in the store, copied out of the ring's row ``slot``; blocks
        the prompt adopted re-resolve to their nodes without a copy.
        Returns the number of new blocks."""
        plan = self.store.insert(tokens)
        new = 0
        for i, (node, is_new) in enumerate(plan):
            if is_new:
                self.commit_block(caches, slot, i * self.block_tokens,
                                  node.block)
                new += 1
        return new
