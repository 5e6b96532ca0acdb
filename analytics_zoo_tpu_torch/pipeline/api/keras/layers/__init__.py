"""Port of ``analytics_zoo_tpu/pipeline/api/keras/layers`` (the core,
embedding and attention layers, the advanced activations, ``LayerNorm``
and ``L2Normalize``)."""

from ..engine import Input, InputLayer, Lambda
from .advanced_activations import (ELU, RReLU, SReLU, BinaryThreshold,
                                   HardShrink, HardTanh, LeakyReLU, PReLU,
                                   SoftShrink, Softmax, Threshold,
                                   ThresholdedReLU)
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

__all__ = ["Activation", "BERT", "BinaryThreshold", "Dense", "Dropout",
           "ELU", "Embedding", "ExpandDim", "Flatten", "GaussianDropout",
           "GaussianNoise", "HardShrink", "HardTanh", "Highway", "Input",
           "InputLayer", "L2Normalize", "Lambda", "LayerNorm", "LeakyReLU",
           "Masking", "Merge", "MultiHeadSelfAttention", "Narrow", "PReLU",
           "Permute", "RReLU", "RepeatVector", "Reshape", "SReLU", "Select",
           "ShardedEmbedding", "SoftShrink", "Softmax", "SparseDense",
           "SparseEmbedding", "Squeeze", "Threshold", "ThresholdedReLU",
           "TimeDistributed", "TransformerBlock", "TransformerLayer",
           "WordEmbedding", "get_activation", "merge", "take_rows"]
