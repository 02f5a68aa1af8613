"""FusedDecoder: the step cores of the serving path.

Counterpart of the paged, greedy subset of
``paddle_tpu/inference/generation.py::FusedDecoder``: the ``_stacked``
weight layout (qkv fused head-major), ``init_paged_cache``, the per-layer
step pieces (``ln``, ``qkv_of``, ``proj_ffn_tail``, ``paged_write``,
``attend``, ``layer_step``), the four hidden cores (``hidden`` for one
token per row, ``spec_hidden`` for a [B, C] block, ``flat_hidden`` for
the flat budget's ragged [T] stream, ``bulk_hidden`` for a whole prompt)
and the dispatches the serving engine builds from them
(``_build_budget_core``, ``_build_flat_budget_core`` and the trailing
decode scan ``_make_budget_tail``).

Where JAX traced a pure function, the port runs eagerly: the layer loop
is a Python loop, and the KV pool is updated IN PLACE (a write through
the block table lands in ``caches["kv"]`` directly, where JAX returned a
new array). Attention goes through the wrappers of ``ops`` — the CUDA
kernels on the card, their plain versions on the CPU:
``decode_attention.decode_attention_paged`` (decode rows, budget
blocks), ``decode_attention.decode_attention_paged_flat`` (the flat
stream's segments) and ``flash_attention.flash_attention`` (bulk
prefill). Each is looked up on its module at call time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import decode_attention as _attn
from ..ops import flash_attention as _fa

__all__ = ["FusedDecoder"]

NEG_INF = -1e30


def _penalize_slots(logits, nt, min_len, eos_ids):
    """min_length: suppress each row's own eos column while that row has
    generated fewer than its min_length tokens (eos_ids < 0: no eos)."""
    cols = torch.arange(logits.shape[1], device=logits.device)[None, :]
    suppress = (cols == eos_ids[:, None]) & (nt < min_len)[:, None]
    return logits.masked_fill(suppress, NEG_INF)


class FusedDecoder:
    """Greedy paged decode around a FusedMultiTransformer, an embedding
    and an LM head (moved to ``device``, default ``cuda``)."""

    def __init__(self, fmt, embed, head, max_seq_len, use_rotary=False,
                 weight_quant=None, kv_quant=None, device=None):
        if use_rotary:
            raise NotImplementedError(
                "use_rotary: rotary embeddings are not ported yet "
                "(ROADMAP Queue 1 item 3, rope_block)")
        if weight_quant not in (None, "none") or kv_quant not in (None,
                                                                  "none"):
            raise NotImplementedError(
                "weight_quant/kv_quant: quantized serving is not ported "
                "yet (ROADMAP Queue 1 item 6(g))")
        if fmt.activation != "gelu":
            raise NotImplementedError(
                f"activation {fmt.activation!r}: the port has gelu only")
        self.device = resolve_device(device)
        self.fmt = fmt.to(self.device)
        self.embed = embed.to(self.device)
        self.head = head.to(self.device)
        # the JAX ring rounds capacity up to a 128-multiple; the port keeps
        # the same Smax so block tables have the same width
        self.smax = -(-int(max_seq_len) // 128) * 128
        self._stk_cache = None

    # ------------------------------------------------------------ weights
    def _stacked(self):
        """Per-layer weights stacked on a leading [L] axis, with qkv fused
        HEAD-MAJOR: [3, nh, hd, E] per layer becomes [L, nh*3*hd, E] (bias
        [L, nh*3*hd]), which ``qkv_of`` unfuses with a (nh, 3, hd)
        reshape. Cached until a parameter is replaced or edited."""
        f = self.fmt
        sig = tuple((id(p), p._version) for p in f.parameters())
        if self._stk_cache is not None and self._stk_cache[0] == sig:
            return self._stk_cache[1]
        self._stk_cache = None

        def stk(plist):
            return torch.stack([p.detach() for p in plist])
        qkv5 = stk(f.qkv_weights)                  # [L, 3, nh, hd, E]
        qkvb4 = stk(f.qkv_biases)                  # [L, 3, nh, hd]
        nl = qkv5.shape[0]
        out = {
            "ln_s": stk(f.ln_scales), "ln_b": stk(f.ln_biases),
            "qkv_w": qkv5.transpose(1, 2).reshape(nl, -1, qkv5.shape[-1]),
            "qkv_b": qkvb4.transpose(1, 2).reshape(nl, -1),
            "lin_w": stk(f.linear_weights), "lin_b": stk(f.linear_biases),
            "fln_s": stk(f.ffn_ln_scales), "fln_b": stk(f.ffn_ln_biases),
            "f1_w": stk(f.ffn1_weights), "f1_b": stk(f.ffn1_biases),
            "f2_w": stk(f.ffn2_weights), "f2_b": stk(f.ffn2_biases),
        }
        self._stk_cache = (sig, out)
        return out

    def init_paged_cache(self, pool, dtype=None):
        """The one KV pool {"kv": [L, 2, NB, H, Bt, D]} for a BlockPool.
        The engine adds this dispatch's block tables as "tbl"."""
        f = self.fmt
        if pool.smax != self.smax:
            raise ValueError(
                f"BlockPool was sized for max_seq_len={pool.smax} but this "
                f"decoder's capacity is Smax={self.smax}")
        dtype = dtype or f.qkv_weights[0].dtype
        shape = (f.num_layers, 2, pool.num_blocks, f.num_heads,
                 pool.block_tokens, f.head_dim)
        return {"kv": torch.zeros(shape, dtype=dtype, device=self.device)}

    # ---------------------------------------------------- step pieces
    def ln(self, x, s, b):
        # fp32 statistics with the population variance, affine in fp32,
        # then back to x's dtype
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + self.fmt.epsilon)
        return (out * s + b).to(x.dtype)

    def qkv_of(self, h, p):
        # [B, T, E] -> q, k, v [B, T, nh, hd] from the head-major fused qkv
        f = self.fmt
        qkv = h @ p["qkv_w"].T + p["qkv_b"].to(h.dtype)
        qkv = qkv.reshape(h.shape[0], h.shape[1], f.num_heads, 3,
                          f.head_dim)
        return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]

    def proj_ffn_tail(self, residual, attn_flat, p):
        # out-projection + residual + FFN, pre- or post-LN
        pre_ln = self.fmt.normalize_before
        x = residual + (attn_flat @ p["lin_w"]
                        + p["lin_b"].to(attn_flat.dtype))
        if not pre_ln:
            x = self.ln(x, p["ln_s"], p["ln_b"])
        residual = x
        h = self.ln(x, p["fln_s"], p["fln_b"]) if pre_ln else x
        h = h @ p["f1_w"] + p["f1_b"].to(h.dtype)
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
        h = h @ p["f2_w"] + p["f2_b"].to(h.dtype)
        x = residual + h
        if not pre_ln:
            x = self.ln(x, p["fln_s"], p["fln_b"])
        return x

    def _paged_blk_off(self, tbl, tv, nb):
        """Resolve positions tv ([B] or [B, Sq]) through the block table:
        a position past the table (the masked-write position Smax) and an
        unmapped entry both resolve to the sentinel block ``nb``."""
        nblk = tbl.shape[1]
        bt = self.smax // nblk
        ji = tv // bt
        jc = ji.clamp(max=nblk - 1)
        tv2 = tv if tv.dim() == 2 else tv[:, None]
        blk = torch.gather(tbl.long(), 1, jc.reshape(tv2.shape).long())
        blk = blk.reshape(tv.shape)
        return torch.where(ji < nblk, blk, torch.full_like(blk, nb)), tv % bt

    def write_targets(self, caches, tv):
        """(block, offset, selector) of the writes that land: positions
        resolving to the sentinel are dropped here, as JAX's scatter
        with mode="drop" drops them (a write never lands in block NB-1 by
        clamping). Computed once per hidden pass; every layer reuses it."""
        nb = caches["kv"].shape[2]
        blk, off = self._paged_blk_off(caches["tbl"], tv, nb)
        keep = (blk < nb).nonzero(as_tuple=True)
        return blk[keep], off[keep].long(), keep

    def paged_write(self, caches, l, targets, kv_new):
        """Scatter the new K/V rows kv_new [2, B, H, Sq, D] of layer l into
        the pool, in place, through ``write_targets``."""
        blk, off, keep = targets
        vals = kv_new.permute(1, 3, 0, 2, 4)          # [B, Sq, 2, H, D]
        if len(keep) == 1:                            # tv was [B]
            vals = vals[:, 0]
        pool_l = caches["kv"][l].permute(1, 3, 0, 2, 4)   # [NB, Bt, 2, H, D]
        pool_l[blk, off] = vals[keep].to(pool_l.dtype)

    def attend(self, q, caches, l, t):
        # q: [B, Sq, H, D]; t: [B] base positions — query row j attends
        # cache positions <= t + j. Looked up on the module at call time.
        qt = q.transpose(1, 2).contiguous()
        tb = t.to(torch.int32).contiguous()
        o = _attn.decode_attention_paged(qt, caches["kv"], caches["tbl"], l,
                                         tb)
        return o.transpose(1, 2)

    def layer_step(self, x, p, caches, l, t, targets):
        f = self.fmt
        residual = x
        h = self.ln(x, p["ln_s"], p["ln_b"]) if f.normalize_before else x
        b, kp = h.shape[0], h.shape[1]
        q, k, v = self.qkv_of(h, p)
        kv_new = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])
        self.paged_write(caches, l, targets, kv_new)
        attn = self.attend(q, caches, l, t)
        return self.proj_ffn_tail(
            residual, attn.reshape(b, kp, f.num_heads * f.head_dim), p)

    def _layers(self, stk):
        return [{k: v[i] for k, v in stk.items()}
                for i in range(self.fmt.num_layers)]

    def hidden(self, stk, caches, tok, t):
        """tok [B], t [B] per-row positions -> x [B, 1, E]; every row's K/V
        is written at its position t (unless it resolves to the
        sentinel)."""
        x = self.embed(tok[:, None])
        targets = self.write_targets(caches, t)
        for l, p in enumerate(self._layers(stk)):
            x = self.layer_step(x, p, caches, l, t, targets)
        return x

    def spec_hidden(self, stk, caches, toks, lens, write_mask):
        """toks [B, Sq] at positions lens[b] + j -> x [B, Sq, E]; only the
        positions where write_mask [B, Sq] holds write their K/V."""
        offs = torch.arange(toks.shape[1], device=toks.device)[None, :]
        tv = torch.where(write_mask, lens[:, None] + offs,
                         torch.full_like(toks, self.smax))
        x = self.embed(toks)
        targets = self.write_targets(caches, tv)
        for l, p in enumerate(self._layers(stk)):
            x = self.layer_step(x, p, caches, l, lens, targets)
        return x

    # ------------------------------------------------ flat budget stream
    def flat_targets(self, caches, tslot, tpos, b):
        """``write_targets`` of the flat stream: token i writes its slot
        tslot[i]'s position tpos[i]. Pad tokens carry the slot sentinel
        b and drop, as does a position past the table or an unmapped
        entry (never clamped into block NB - 1)."""
        rows = caches["tbl"][tslot.clamp(max=b - 1)]
        tv = torch.where(tslot < b, tpos, torch.full_like(tpos, self.smax))
        return self.write_targets(dict(caches, tbl=rows), tv)

    def flat_write(self, caches, l, targets, kv_new):
        """Scatter the stream's K/V kv_new [2, 1, H, T, D] of layer l into
        the pool, in place: each token is a row of one position."""
        self.paged_write(caches, l, targets,
                         kv_new[:, 0].transpose(1, 2)[:, :, :, None])

    def flat_attend_seg(self, q_s, caches, l, cmeta, b):
        """The segment region's attention: q_s [Ts, H, D] in aligned
        single-slot chunks with cmeta = (cslot, cbase, cn) int32 per
        chunk. The kernel takes every block size the engine makes, so
        there is no gather fallback on the card."""
        cslot, cbase, cn = cmeta
        return _attn.decode_attention_paged_flat(
            q_s.contiguous(), caches["kv"], caches["tbl"],
            cslot.clamp(max=b - 1), cbase, cn, l)

    def flat_layer_step(self, x, p, caches, l, tpos, targets, cmeta, b):
        """One layer over the whole [1, T] stream: dense ops on every
        token, K/V written to (slot, pos), then attention by region —
        tokens [0, b) are the decode region (token i is slot i, through
        decode_attention_paged over all b rows; idle rows' outputs are
        discarded by the caller), the rest go through the flat kernel."""
        f = self.fmt
        nh, hd = f.num_heads, f.head_dim
        residual = x
        h = self.ln(x, p["ln_s"], p["ln_b"]) if f.normalize_before else x
        t_all = h.shape[1]
        q, k, v = self.qkv_of(h, p)                   # [1, T, H, D]
        kv_new = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])
        self.flat_write(caches, l, targets, kv_new)
        ad = self.attend(q[0, :b][:, None], caches, l, tpos[:b])
        parts = [ad.reshape(1, b, nh * hd)]
        if t_all > b:
            a_s = self.flat_attend_seg(q[0, b:], caches, l, cmeta, b)
            parts.append(a_s.reshape(1, t_all - b, nh * hd))
        return self.proj_ffn_tail(residual, torch.cat(parts, 1), p)

    def flat_hidden(self, stk, caches, toks, tslot, tpos, cmeta, b):
        """toks/tslot/tpos [T], the flat stream (decode region [0, b) plus
        aligned segments) -> x [1, T, E], every valid token's K/V landed
        at (slot, pos)."""
        x = self.embed(toks[None, :])
        targets = self.flat_targets(caches, tslot, tpos, b)
        for l, p in enumerate(self._layers(stk)):
            x = self.flat_layer_step(x, p, caches, l, tpos, targets, cmeta,
                                     b)
        return x

    # ------------------------------------------------------- bulk prefill
    def bulk_hidden(self, stk, toks):
        """Whole-prompt prefill, no rotary: toks [B, S] at positions 0..S-1
        through the layer stack with causal flash attention. Returns
        (x [B, S, E], kv_all [L, 2, B, H, S, D]); writing kv_all into a
        cache is the caller's."""
        f = self.fmt
        x = self.embed(toks)
        kvs = []
        for p in self._layers(stk):
            residual = x
            h = self.ln(x, p["ln_s"], p["ln_b"]) if f.normalize_before else x
            bsz, sl = h.shape[:2]
            q, k, v = self.qkv_of(h, p)
            o = _fa.flash_attention(q, k, v, causal=True)
            x = self.proj_ffn_tail(
                residual, o.reshape(bsz, sl, f.num_heads * f.head_dim), p)
            kvs.append(torch.stack([k.transpose(1, 2), v.transpose(1, 2)]))
        return x, torch.stack(kvs)

    def head_logits(self, x):
        return self.head(x)

    # ------------------------------------------------- serving dispatches
    def _make_budget_tail(self, nscan):
        """The trailing decode scan (also the plain decode chunk): nscan
        greedy steps over all rows. Every row writes its K/V at its lens
        (sentinel rows drop); only active rows advance. Returns
        run(stk, caches, tok, lens, active, nt, max_nt, eos_ids, min_len)
        -> ((tok, lens, active, nt), (toks [nscan, B], emitted [nscan, B]))."""
        def run(stk, caches, tok, lens, active, nt, max_nt, eos_ids,
                min_len):
            ys_t, ys_e = [], []
            for _ in range(nscan):
                x = self.hidden(stk, caches, tok, lens)
                lg = self.head_logits(x).reshape(x.shape[0], -1)
                lg = _penalize_slots(lg, nt, min_len, eos_ids)
                nxt = lg.argmax(-1).to(tok.dtype)
                emitted = active
                hit_eos = (eos_ids >= 0) & (nxt == eos_ids)
                step = active.to(nt.dtype)
                nt = nt + step
                lens = lens + step
                active = active & ~hit_eos & (nt < max_nt)
                tok = torch.where(emitted, nxt, tok)
                ys_t.append(nxt)
                ys_e.append(emitted)
            if nscan:
                ys = (torch.stack(ys_t), torch.stack(ys_e))
            else:
                ys = (tok.new_zeros((0, tok.shape[0])),
                      active.new_zeros((0, active.shape[0])))
            return (tok, lens, active, nt), ys
        return run

    def _build_budget_core(self, c, scan_tail=0):
        """The row-layout token-budget step, greedy, without drafts: row b
        feeds seg[b] tokens of toks [B, C] at positions lens[b]..; the
        last valid column's logits sample the row's next token (kept
        when gen0[b] < seg[b], i.e. the row is generating), then
        ``scan_tail`` trailing decode steps run in the same call.
        Returns budget(stk, caches, toks, lens, seg, gen0, nt, max_nt,
        eos_ids, min_len) -> (tok0, emit0, ys, tok, lens, active, nt)."""
        c = int(c)
        tail = self._make_budget_tail(int(scan_tail))

        def budget(stk, caches, toks, lens, seg, gen0, nt, max_nt, eos_ids,
                   min_len):
            offs = torch.arange(c, device=toks.device)[None, :]
            valid = (offs < seg[:, None]) & (lens[:, None] + offs < self.smax)
            x = self.spec_hidden(stk, caches, toks, lens, valid)
            last = (seg - 1).clamp(min=0).long()
            xl = x[torch.arange(x.shape[0], device=x.device), last][:, None]
            logits = self.head_logits(xl).reshape(x.shape[0], -1)
            logits = _penalize_slots(logits, nt, min_len, eos_ids)
            tok0 = logits.argmax(-1).to(toks.dtype)
            emit0 = (seg > 0) & (gen0 < seg)
            hit_eos = (eos_ids >= 0) & (tok0 == eos_ids)
            lens = lens + seg
            nt = nt + emit0.to(nt.dtype)
            active = emit0 & ~hit_eos & (nt < max_nt)
            tok = torch.where(emit0, tok0, toks[:, 0])
            (tok, lens, active, nt), ys = tail(
                stk, caches, tok, lens, active, nt, max_nt, eos_ids,
                min_len)
            return tok0, emit0, ys, tok, lens, active, nt
        return budget

    def _build_flat_budget_core(self, b, scan_tail=0):
        """The token-flattened budget step, greedy, without drafts: one
        ragged [T] stream (decode region [0, b), then segments aligned to
        FLAT_CHUNK), each slot's next token sampled from its last valid
        stream index ``last_idx``, then ``scan_tail`` trailing decode
        steps. ``emit0`` and ``adv`` come from the packer. Returns
        flat_budget(stk, caches, toks, tslot, tpos, cslot, cbase, cn,
        tok_in, last_idx, emit0, adv, lens, nt, max_nt, eos_ids, min_len)
        -> (tok0, emit0, ys, tok, lens, active, nt), as the row core."""
        b = int(b)
        tail = self._make_budget_tail(int(scan_tail))

        def flat_budget(stk, caches, toks, tslot, tpos, cslot, cbase, cn,
                        tok_in, last_idx, emit0, adv, lens, nt, max_nt,
                        eos_ids, min_len):
            x = self.flat_hidden(stk, caches, toks, tslot, tpos,
                                 (cslot, cbase, cn), b)
            xl = x[0, last_idx][:, None]
            logits = self.head_logits(xl).reshape(b, -1)
            logits = _penalize_slots(logits, nt, min_len, eos_ids)
            tok0 = logits.argmax(-1).to(tok_in.dtype)
            hit_eos = (eos_ids >= 0) & (tok0 == eos_ids)
            lens = lens + adv
            nt = nt + emit0.to(nt.dtype)
            active = emit0 & ~hit_eos & (nt < max_nt)
            tok = torch.where(emit0, tok0, tok_in)
            (tok, lens, active, nt), ys = tail(
                stk, caches, tok, lens, active, nt, max_nt, eos_ids,
                min_len)
            return tok0, emit0, ys, tok, lens, active, nt
        return flat_budget
