"""Port of ``analytics_zoo_tpu/pipeline/api/keras/layers`` (the layers
the ported paths need)."""

from .core import Activation, Dense, Dropout, Merge, Select, merge
from .embeddings import Embedding, ShardedEmbedding, take_rows
from .normalization import LayerNorm
from .self_attention import (BERT, MultiHeadSelfAttention, TransformerBlock,
                             TransformerLayer)

__all__ = ["Activation", "Dense", "Dropout", "Embedding", "LayerNorm",
           "Merge", "Select", "ShardedEmbedding", "merge", "take_rows", "BERT",
           "MultiHeadSelfAttention", "TransformerBlock", "TransformerLayer"]
