"""Port of ``analytics_zoo_tpu/pipeline/api/keras/layers`` (the core,
embedding, attention, convolution, pooling and normalization layers and
the advanced activations)."""

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
from .convolution import (AtrousConvolution1D, AtrousConvolution2D,
                          Convolution1D, Convolution2D, Cropping1D,
                          Cropping2D, Deconvolution2D,
                          DepthwiseConvolution2D, LocallyConnected1D,
                          SeparableConvolution1D, SeparableConvolution2D,
                          ShareConvolution2D, UpSampling1D, UpSampling2D,
                          ZeroPadding1D, ZeroPadding2D)
from .normalization import BatchNormalization, L2Normalize, LayerNorm
from .pooling import (AveragePooling1D, AveragePooling2D, AveragePooling3D,
                      GlobalAveragePooling1D, GlobalAveragePooling2D,
                      GlobalAveragePooling3D, GlobalMaxPooling1D,
                      GlobalMaxPooling2D, GlobalMaxPooling3D, KMaxPooling,
                      MaxPooling1D, MaxPooling2D, MaxPooling3D)
from .self_attention import (BERT, MultiHeadSelfAttention, TransformerBlock,
                             TransformerLayer)

__all__ = ["Activation", "AtrousConvolution1D", "AtrousConvolution2D",
           "AveragePooling1D", "AveragePooling2D", "AveragePooling3D",
           "BERT", "BatchNormalization", "BinaryThreshold",
           "Convolution1D", "Convolution2D", "Cropping1D", "Cropping2D",
           "Deconvolution2D", "Dense", "DepthwiseConvolution2D", "Dropout",
           "ELU", "Embedding", "ExpandDim", "Flatten", "GaussianDropout",
           "GaussianNoise", "GlobalAveragePooling1D",
           "GlobalAveragePooling2D", "GlobalAveragePooling3D",
           "GlobalMaxPooling1D", "GlobalMaxPooling2D",
           "GlobalMaxPooling3D", "HardShrink", "HardTanh", "Highway",
           "Input", "InputLayer", "KMaxPooling", "L2Normalize", "Lambda",
           "LayerNorm", "LeakyReLU", "LocallyConnected1D", "Masking",
           "MaxPooling1D", "MaxPooling2D", "MaxPooling3D", "Merge",
           "MultiHeadSelfAttention", "Narrow", "PReLU", "Permute", "RReLU",
           "RepeatVector", "Reshape", "SReLU", "Select",
           "SeparableConvolution1D", "SeparableConvolution2D",
           "ShardedEmbedding", "ShareConvolution2D", "SoftShrink",
           "Softmax", "SparseDense", "SparseEmbedding", "Squeeze",
           "Threshold", "ThresholdedReLU", "TimeDistributed",
           "TransformerBlock", "TransformerLayer", "UpSampling1D",
           "UpSampling2D", "WordEmbedding", "ZeroPadding1D",
           "ZeroPadding2D", "get_activation", "merge", "take_rows"]
