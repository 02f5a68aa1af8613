"""The optimizers and learning-rate schedulers (``lr``). Counterpart of
``paddle_tpu/optimizer/__init__.py``; ``L1Decay`` / ``L2Decay`` are
``regularizer``'s, re-exported under their older spelling."""
from . import lr
from .optimizer import (ASGD, SGD, Adadelta, Adafactor, Adagrad, Adam,
                        Adamax, AdamW, Lamb, Momentum, NAdam, Optimizer,
                        RAdam, RMSProp, Rprop)
from ..regularizer import L1Decay, L2Decay

__all__ = ["ASGD", "SGD", "Adadelta", "Adafactor", "Adagrad", "Adam",
           "Adamax", "AdamW", "L1Decay", "L2Decay", "Lamb", "Momentum",
           "NAdam", "Optimizer", "RAdam", "RMSProp", "Rprop", "lr"]
