"""Port of ``analytics_zoo_tpu/pipeline/api/keras/layers`` (the layers
the ported paths need)."""

from .core import Dense, Dropout
from .embeddings import take_rows
from .normalization import LayerNorm
from .self_attention import (BERT, MultiHeadSelfAttention, TransformerBlock,
                             TransformerLayer)

__all__ = ["Dense", "Dropout", "LayerNorm", "take_rows", "BERT",
           "MultiHeadSelfAttention", "TransformerBlock", "TransformerLayer"]
