from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from .utils_ import ParamAttr

__all__ = sorted([*_layers, "ClipGradByGlobalNorm", "ClipGradByNorm",
                  "ClipGradByValue", "ParamAttr", "functional",
                  "initializer"])
