from .common import Dropout, Embedding, Linear
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "RMSNorm", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
