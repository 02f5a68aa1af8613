"""``ParamAttr``. Counterpart of ``paddle_tpu/nn/utils_.py``.

The layers that take a ``weight_attr`` / ``bias_attr`` (``Linear``,
``Embedding``) draw the parameter from its ``initializer`` and set the
attributes the optimizer and the clips read on the ``nn.Parameter``:
``optimize_attr = {"learning_rate": ...}``, ``regularizer`` and
``need_clip``; ``trainable=False`` freezes it (``requires_grad``).
``do_model_average`` is taken and, as in JAX, unused.
"""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip
