"""LLaMA-2 family for training. Counterpart of ``paddle_tpu/models/llama.py``.

The same modules, parameter names and shapes as the JAX model (RMSNorm,
rotary embeddings, GQA attention, the SwiGLU MLP, a head tied to the
embedding or not, ``[in, out]`` projections), so
``weights.llama_from_jax_state`` moves a JAX state across by name. Every
RMSNorm goes through the RMSNorm kernels (``nn.functional.rms_norm``),
attention through ``nn.functional.scaled_dot_product_attention`` (the
flash attention kernels, forward and backward) and rotary through the
ported ``fused_rotary_position_embedding``; the projections are
``torch.matmul`` on cuBLAS, as the JAX package leaves them to XLA.

Both of the JAX model's layouts are ported. ``tensor_parallel=True`` (its
default) builds fleet's model-parallel layers, as JAX's does: q/k/v and
gate/up as ``ColumnParallelLinear`` (outputs split), o and down as
``RowParallelLinear`` (inputs split, partial sums all-reduced), a
``VocabParallelEmbedding``, a ``ColumnParallelLinear`` head with its
logits left split on the vocabulary, and ``ParallelCrossEntropy``. Under
a fleet topology with a model degree over processes each mp rank runs
``num_heads / mp`` query heads and ``num_kv_heads / mp`` K/V heads
through the flash kernels, and returns its vocabulary slice of the
logits; at mp 1 the layers are plain projections and the loss the dense
``cross_entropy(..., reduction="none")``. A tied head is ``F.linear`` on
the (vocab-split) embedding, behind ``_c_identity`` so that its input's
gradient is summed over mp. ``num_kv_heads % mp != 0`` raises
(ROADMAP Queue 1 item 10(f)). ``tensor_parallel=False`` runs q/k/v as
one matmul and gate/up as one (``fused_concat_linear``), with the
parameters kept separate. ``context_parallel`` (True or
"ring", or "ulysses") runs attention over the active fleet mesh's ``sep``
axis when its degree is 2 or more (``parallel.context_parallel``: the ring
chunk kernels, or the flash kernels under Ulysses) and dense attention
otherwise; ``sequence_parallel`` does what the JAX model does without a
mesh: no sharding constraint. ``recompute`` recomputes each block's
activations in backward through ``fleet.utils.recompute``, as JAX's block
does.

The initial weights are drawn from the model's ``generator``, a CPU
``torch.Generator`` seeded from ``seed``, each at its full logical shape
(an mp rank keeps its slice), so a seed gives the same model on every
device and at every model-parallel degree.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.fleet.layers.mpu import mp_layers as mpl
from ..distributed.fleet.layers.mpu.mp_ops import _Identity, _run
from ..incubate.nn.functional import fused_rotary_position_embedding
from ..nn import functional as F
from ..nn.layer.common import Embedding, Linear
from ..nn.layer.norm import RMSNorm

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaBlock",
           "LlamaModel", "LlamaForCausalLM", "llama2_7b", "llama2_65b",
           "llama_tiny"]


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096, num_layers=32,
                 num_heads=32, num_kv_heads=None, intermediate_size=11008,
                 max_position=4096, rms_eps=1e-5, rope_base=10000.0,
                 initializer_range=0.02, tensor_parallel=True,
                 sequence_parallel=False, recompute=False,
                 tie_word_embeddings=False, context_parallel=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.rms_eps = rms_eps
        self.rope_base = rope_base
        self.initializer_range = initializer_range
        self.tensor_parallel = tensor_parallel
        self.sequence_parallel = sequence_parallel
        self.recompute = recompute
        self.tie_word_embeddings = tie_word_embeddings
        self.context_parallel = context_parallel


def _linear(n_in, n_out, device, dtype):
    return Linear(n_in, n_out, bias_attr=False, dtype=dtype, device=device,
                  trainable=True)


def _column(c, n_in, n_out, device, dtype):
    """A column-split projection (its output split over mp) under
    ``tensor_parallel``, else a plain one."""
    if not c.tensor_parallel:
        return _linear(n_in, n_out, device, dtype)
    return mpl.ColumnParallelLinear(n_in, n_out, has_bias=False,
                                    gather_output=False, dtype=dtype,
                                    device=device)


def _row(c, n_in, n_out, device, dtype):
    """A row-split projection (its input split over mp) under
    ``tensor_parallel``, else a plain one."""
    if not c.tensor_parallel:
        return _linear(n_in, n_out, device, dtype)
    return mpl.RowParallelLinear(n_in, n_out, has_bias=False,
                                 input_is_parallel=True, dtype=dtype,
                                 device=device)


def _mp_degree(c):
    """The model-parallel degree the model's layers split over."""
    if not c.tensor_parallel:
        return 1
    from ..distributed.fleet.layers.mpu.mp_ops import mp_group
    g = mp_group()
    return 1 if g is None else g.nranks


class LlamaAttention(nn.Module):
    def __init__(self, c: LlamaConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        mp = _mp_degree(c)
        if c.num_kv_heads % mp:
            raise NotImplementedError(
                f"LlamaAttention: num_kv_heads {c.num_kv_heads} over a "
                f"model-parallel degree {mp} that does not divide it (K/V "
                "heads replicated across mp ranks) is not ported (ROADMAP "
                "Queue 1 item 10(f))")
        # this rank's heads: all of them below mp 2
        self.num_heads = c.num_heads // mp
        self.num_kv_heads = c.num_kv_heads // mp
        self.head_dim = c.hidden_size // c.num_heads
        self.rope_base = c.rope_base
        self.context_parallel = c.context_parallel
        self._ring_cache = None
        # one matmul for q, k and v (the JAX model's non-TP fast path)
        self.fused = not c.tensor_parallel
        h = c.hidden_size
        kv_out = c.num_kv_heads * self.head_dim
        self.q_proj = _column(c, h, h, device, dtype)
        self.k_proj = _column(c, h, kv_out, device, dtype)
        self.v_proj = _column(c, h, kv_out, device, dtype)
        self.o_proj = _row(c, h, h, device, dtype)

    def _ring_fn(self):
        """Sequence-parallel attention over the active mesh's 'sep' axis
        (cached per mesh and scheme); None when no mesh with sep >= 2 is
        active. context_parallel=True/'ring' runs exact ring attention;
        'ulysses' the head-scatter all-to-all with full-sequence attention
        per rank (kv_heads % sep == 0)."""
        from ..parallel import current_mesh
        mesh = current_mesh()
        names = getattr(mesh, "mesh_dim_names", None) or ()
        if "sep" not in names or mesh.shape[names.index("sep")] < 2:
            return None
        scheme = ("ulysses" if self.context_parallel == "ulysses"
                  else "ring")
        if self._ring_cache is None or self._ring_cache[0] is not mesh \
                or self._ring_cache[2] != scheme:
            from ..parallel.context_parallel import (
                make_ring_attention_fn, make_ulysses_attention_fn)
            mk = (make_ulysses_attention_fn if scheme == "ulysses"
                  else make_ring_attention_fn)
            self._ring_cache = (mesh, mk(mesh, axis_name="sep",
                                         causal=True), scheme)
        return self._ring_cache[1]

    def forward(self, x, kv_cache=None, time_step=None):
        """x [B, S, hidden] -> (out [B, S, hidden], kv_cache). With
        ``kv_cache`` (k, v) [B, S0, H, D] (K/V already repeated over the
        heads) the new K/V are appended and the queries attend the whole
        cache without a causal mask; rotary positions start at 0 whatever
        the cache holds, and ``time_step`` is not read (both as in the JAX
        model)."""
        b, s = x.shape[0], x.shape[1]
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        if self.fused:
            qkv = F.fused_concat_linear(
                x, [self.q_proj.weight, self.k_proj.weight,
                    self.v_proj.weight])
            q = qkv[..., :nh * hd].reshape(b, s, nh, hd)
            k = qkv[..., nh * hd:(nh + nkv) * hd].reshape(b, s, nkv, hd)
            v = qkv[..., (nh + nkv) * hd:].reshape(b, s, nkv, hd)
        else:
            q = self.q_proj(x).reshape(b, s, nh, hd)
            k = self.k_proj(x).reshape(b, s, nkv, hd)
            v = self.v_proj(x).reshape(b, s, nkv, hd)
        q, k, _ = fused_rotary_position_embedding(
            q, k, None, rotary_emb_base=self.rope_base)
        if nkv != nh:
            # jnp.repeat(a, rep, axis=2): each kv head next to its copies
            k = k.repeat_interleave(nh // nkv, dim=2)
            v = v.repeat_interleave(nh // nkv, dim=2)
        if kv_cache is not None:
            k_cat, v_cat, kv_cache = _append_cache(kv_cache, k, v)
            out = F.scaled_dot_product_attention(q, k_cat, v_cat)
        elif self.context_parallel and self._ring_fn() is not None:
            out = self._ring_fn()(q, k, v)
        else:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, s, nh * hd)), kv_cache


def _append_cache(cache, k, v):
    kc, vc = cache
    k_cat = torch.cat([kc, k], 1)
    v_cat = torch.cat([vc, v], 1)
    return k_cat, v_cat, (k_cat, v_cat)


class LlamaMLP(nn.Module):
    def __init__(self, c: LlamaConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        h, inter = c.hidden_size, c.intermediate_size
        # gate and up as one matmul (the JAX model's non-TP fast path)
        self.fused = not c.tensor_parallel
        self.gate_proj = _column(c, h, inter, device, dtype)
        self.up_proj = _column(c, h, inter, device, dtype)
        self.down_proj = _row(c, inter, h, device, dtype)

    def forward(self, x):
        if self.fused:
            inter = self.gate_proj.weight.shape[1]
            gu = F.fused_concat_linear(
                x, [self.gate_proj.weight, self.up_proj.weight])
            return self.down_proj(F.silu(gu[..., :inter]) * gu[..., inter:])
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, c: LlamaConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_eps, dtype=dtype,
                                       device=device)
        self.self_attn = LlamaAttention(c, device=device, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_eps,
                                                dtype=dtype, device=device)
        self.mlp = LlamaMLP(c, device=device, dtype=dtype)
        self._recompute = c.recompute

    def _body(self, x):
        attn_out, _ = self.self_attn(self.input_layernorm(x))
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x):
        if self._recompute and self.training:
            from ..distributed.fleet.utils.recompute_mod import recompute
            return recompute(self._body, x)
        return self._body(x)


class LlamaModel(nn.Module):
    def __init__(self, c: LlamaConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = c
        self.embed_tokens = (
            mpl.VocabParallelEmbedding(c.vocab_size, c.hidden_size,
                                       dtype=dtype, device=device)
            if c.tensor_parallel else
            Embedding(c.vocab_size, c.hidden_size, dtype=dtype,
                      device=device, trainable=True))
        self.layers = nn.ModuleList([LlamaBlock(c, device=device, dtype=dtype)
                                     for _ in range(c.num_layers)])
        self.norm = RMSNorm(c.hidden_size, c.rms_eps, dtype=dtype,
                            device=device)

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        for blk in self.layers:
            x = blk(x)
        return self.norm(x)


_MP_LAYERS = (mpl.ColumnParallelLinear, mpl.RowParallelLinear,
              mpl.VocabParallelEmbedding)


class LlamaForCausalLM(nn.Module):
    """LLaMA with its LM head (``lm_head``, or the embedding transposed
    under ``tie_word_embeddings``). With ``labels`` the forward returns the
    mean cross entropy, or with ``loss_mask`` its mean weighted by the mask
    (sum(loss m) / max(sum(m), 1)); a label equal to -100 gives a zero term
    that stays in the unmasked mean's count, as in the JAX model.

    ``device`` None means the card (``resolve_device``); ``"meta"`` builds
    the modules without storage or initial values (for a state loaded
    afterwards, ``weights.llama_from_jax_state``)."""

    def __init__(self, c: LlamaConfig, *, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.config = c
        self.generator = torch.Generator()
        self.generator.manual_seed(seed)
        self.llama = LlamaModel(c, device=dev, dtype=dtype)
        if not c.tie_word_embeddings:
            self.lm_head = _column(c, c.hidden_size, c.vocab_size, dev,
                                   dtype)
        if c.tensor_parallel:
            self.parallel_loss = mpl.ParallelCrossEntropy()
        if dev.type != "meta":
            self.init_weights()

    @torch.no_grad()
    def init_weights(self):
        """The JAX model's initialisers, drawn from ``self.generator`` on
        the CPU: every embedding and projection normal(0,
        initializer_range); the RMSNorm weights start at 1 when built."""
        std = self.config.initializer_range
        for module in self.modules():
            if isinstance(module, (Linear, Embedding, *_MP_LAYERS)):
                w = module.weight
                full = torch.empty(mpl.logical_shape(w)).normal_(
                    0.0, std, generator=self.generator)
                w.copy_(mpl.local_slice(full, getattr(w, "split_axis", None),
                                        mpl.mp_split(w)))

    def forward(self, input_ids, labels=None, loss_mask=None):
        h = self.llama(input_ids)
        if self.config.tie_word_embeddings:
            emb = self.llama.embed_tokens
            if self.config.tensor_parallel:
                h = _run(_Identity, h, emb._group)
            logits = F.linear(h, emb.weight.t())
        else:
            logits = self.lm_head(h)
        if labels is None:
            return logits
        if self.config.tensor_parallel:
            loss = self.parallel_loss(logits.reshape(-1, logits.shape[-1]),
                                      labels.reshape(-1))
        else:
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   labels.reshape(-1), reduction="none")
        if loss_mask is None:
            return loss.mean()
        m = loss_mask.reshape(-1).to(loss.dtype)
        return (loss * m).sum() / m.sum().clamp(min=1.0)


def llama2_7b(*, device=None, dtype=torch.float32, seed=0, **kw):
    """LLaMA-2 7B: hidden 4096, 32 layers, 32 heads, intermediate 11008
    (``kw``: any other LlamaConfig field)."""
    return LlamaForCausalLM(LlamaConfig(hidden_size=4096, num_layers=32,
                                        num_heads=32,
                                        intermediate_size=11008, **kw),
                            device=device, dtype=dtype, seed=seed)


def llama2_65b(*, device=None, dtype=torch.float32, seed=0, **kw):
    """LLaMA-2 65B's widths: hidden 8192, 80 layers, 64 heads, intermediate
    22016."""
    return LlamaForCausalLM(LlamaConfig(hidden_size=8192, num_layers=80,
                                        num_heads=64,
                                        intermediate_size=22016, **kw),
                            device=device, dtype=dtype, seed=seed)


def llama_tiny(vocab_size=256, *, device=None, dtype=torch.float32,
               seed=0, **kw):
    """The JAX package's test model: hidden 64, 2 layers, 4 heads,
    intermediate 128, 128 positions."""
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position=128, **kw), device=device,
        dtype=dtype, seed=seed)
