"""Host allocator of the paged KV pool, and the flat stream's gather.

Counterpart of ``paddle_tpu/inference/paged_kv.py::BlockPool`` (the
allocator only): a free list plus per-block refcounts over the one
device pool ``[L, 2, NB, H, Bt, D]`` that
``FusedDecoder.init_paged_cache`` allocates. Position ``s`` of slot
``b`` lives in block ``tables[b, s // Bt]`` at offset ``s % Bt``;
unmapped table entries hold the sentinel ``num_blocks``. Also
``flat_gather_view``, the dense view the plain flat attentions build on
(fp pools, and int8 pools with their scales).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BlockPool", "flat_gather_view"]


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
