"""PyTorch/CUDA port of paddle_tpu's serving path, GPT-2, LLaMA and BERT
training, fused layers and context parallelism.

A second package beside ``paddle_tpu/``, mirroring its module paths:
``incubate.nn.layer.FusedMultiTransformer`` holds the serving weights,
``inference.generation.FusedDecoder`` runs the step cores,
``inference.serving.ServingEngine`` schedules requests over the paged KV
pool (fp or int8); ``models.gpt.GPTForCausalLM`` with ``nn`` (functional
and layers) and ``optimizer.AdamW`` trains; ``incubate.nn`` has the fused
layers (``FusedFeedForward``, ``FusedMultiTransformer`` with its KV-cache
forward) and their functionals; ``models.llama`` trains LLaMA, over
``distributed.fleet``'s ``sep`` mesh with ``parallel``'s ring or Ulysses
attention under ``context_parallel``; ``distributed`` runs the
collectives, ``DataParallel`` and the GroupSharded stages over
``torch.distributed`` process groups; ``models.bert`` pretrains BERT over
``nn``'s Transformer layers under ``amp`` (O1 / O2, ``GradScaler``) with
the ``optimizer``s, ``optimizer.lr``'s schedulers, ``nn.clip`` and the
``regularizer``s; and ``ops.decode_attention``,
``ops.flash_attention``, ``ops.ring_chunk_attention``, ``ops.layer_norm``,
``ops.fused_dequant_matmul`` and ``ops.fused_ffn`` hold the hand-written
Hopper kernels that attention, the ring's chunk step, LayerNorm and
RMSNorm, the int4 weight matmuls and the fused FFN run.
``weights.from_jax_state`` and ``weights.gpt_from_jax_state`` are the
ways weights cross from the JAX package. Nothing here imports JAX or
``paddle_tpu``.
"""
from .device import TOLERANCES, resolve_device

__all__ = ["TOLERANCES", "resolve_device"]
