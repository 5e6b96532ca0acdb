"""Port of ``analytics_zoo_tpu/pipeline/api/keras/layers`` (the core,
embedding and attention layers, ``LayerNorm`` and ``L2Normalize``)."""

from ..engine import Input, InputLayer, Lambda
from .core import (Activation, Dense, Dropout, ExpandDim, Flatten,
                   GaussianDropout, GaussianNoise, Highway, Masking, Merge,
                   Narrow, Permute, RepeatVector, Reshape, Select,
                   SparseDense, Squeeze, TimeDistributed, get_activation,
                   merge)
from .embeddings import (Embedding, ShardedEmbedding, SparseEmbedding,
                         WordEmbedding, take_rows)
from .normalization import L2Normalize, LayerNorm
from .self_attention import (BERT, MultiHeadSelfAttention, TransformerBlock,
                             TransformerLayer)

__all__ = ["Activation", "BERT", "Dense", "Dropout", "Embedding",
           "ExpandDim", "Flatten", "GaussianDropout", "GaussianNoise",
           "Highway", "Input", "InputLayer", "L2Normalize", "Lambda",
           "LayerNorm", "Masking", "Merge", "MultiHeadSelfAttention",
           "Narrow", "Permute", "RepeatVector", "Reshape", "Select",
           "ShardedEmbedding", "SparseDense", "SparseEmbedding", "Squeeze",
           "TimeDistributed", "TransformerBlock", "TransformerLayer",
           "WordEmbedding", "get_activation", "merge", "take_rows"]
