"""PyTorch/CUDA port of paddle_tpu's serving path.

A second package beside ``paddle_tpu/``, mirroring its module paths:
``incubate.nn.layer.FusedMultiTransformer`` holds the weights,
``inference.generation.FusedDecoder`` runs the step cores,
``inference.serving.ServingEngine`` schedules requests over the paged KV
pool (fp or int8), and ``ops.decode_attention``, ``ops.flash_attention``
and ``ops.fused_dequant_matmul`` hold the hand-written Hopper kernels
that the attention and the int4 weight matmuls run.
``weights.from_jax_state`` is the one way weights cross from the JAX
package. Nothing here imports JAX or ``paddle_tpu``.
"""
from .device import TOLERANCES, resolve_device

__all__ = ["TOLERANCES", "resolve_device"]
