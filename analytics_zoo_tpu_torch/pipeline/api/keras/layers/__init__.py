"""Port of ``analytics_zoo_tpu/pipeline/api/keras/layers`` (the core,
embedding, attention, convolution, 3D convolution, pooling, recurrent,
element-wise and normalization layers and the advanced activations)."""

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
from .convolution3d import (LRN2D, ConvLSTM2D, ConvLSTM3D, Convolution3D,
                            Cropping3D, LocallyConnected2D, MaxoutDense,
                            SpatialDropout1D, SpatialDropout2D,
                            SpatialDropout3D, UpSampling3D,
                            WithinChannelLRN, ZeroPadding3D)
from .elementwise import (AddConstant, CAdd, CMul, Exp, Expand,
                          GaussianSampler, Log, Max, Mul, MulConstant,
                          Negative, Power, ResizeBilinear, Scale, Sqrt,
                          Square)
from .normalization import BatchNormalization, L2Normalize, LayerNorm
from .pooling import (AveragePooling1D, AveragePooling2D, AveragePooling3D,
                      GlobalAveragePooling1D, GlobalAveragePooling2D,
                      GlobalAveragePooling3D, GlobalMaxPooling1D,
                      GlobalMaxPooling2D, GlobalMaxPooling3D, KMaxPooling,
                      MaxPooling1D, MaxPooling2D, MaxPooling3D)
from .recurrent import GRU, LSTM, Bidirectional, SimpleRNN
from .self_attention import (BERT, MultiHeadSelfAttention, TransformerBlock,
                             TransformerLayer)

__all__ = ["Activation", "AddConstant", "AtrousConvolution1D",
           "AtrousConvolution2D", "AveragePooling1D",
           "AveragePooling2D", "AveragePooling3D",
           "BatchNormalization", "BERT", "Bidirectional",
           "BinaryThreshold", "CAdd", "CMul", "ConvLSTM2D",
           "ConvLSTM3D", "Convolution1D", "Convolution2D",
           "Convolution3D", "Cropping1D", "Cropping2D",
           "Cropping3D", "Deconvolution2D", "Dense",
           "DepthwiseConvolution2D", "Dropout", "ELU", "Embedding",
           "Exp", "Expand", "ExpandDim", "Flatten",
           "GaussianDropout", "GaussianNoise", "GaussianSampler",
           "get_activation", "GlobalAveragePooling1D",
           "GlobalAveragePooling2D", "GlobalAveragePooling3D",
           "GlobalMaxPooling1D", "GlobalMaxPooling2D",
           "GlobalMaxPooling3D", "GRU", "HardShrink", "HardTanh",
           "Highway", "Input", "InputLayer", "KMaxPooling",
           "L2Normalize", "Lambda", "LayerNorm", "LeakyReLU",
           "LocallyConnected1D", "LocallyConnected2D", "Log",
           "LRN2D", "LSTM", "Masking", "Max", "MaxoutDense",
           "MaxPooling1D", "MaxPooling2D", "MaxPooling3D", "Merge",
           "merge", "Mul", "MulConstant", "MultiHeadSelfAttention",
           "Narrow", "Negative", "Permute", "Power", "PReLU",
           "RepeatVector", "Reshape", "ResizeBilinear", "RReLU",
           "Scale", "Select", "SeparableConvolution1D",
           "SeparableConvolution2D", "ShardedEmbedding",
           "ShareConvolution2D", "SimpleRNN", "Softmax",
           "SoftShrink", "SparseDense", "SparseEmbedding",
           "SpatialDropout1D", "SpatialDropout2D",
           "SpatialDropout3D", "Sqrt", "Square", "Squeeze", "SReLU",
           "take_rows", "Threshold", "ThresholdedReLU",
           "TimeDistributed", "TransformerBlock",
           "TransformerLayer", "UpSampling1D", "UpSampling2D",
           "UpSampling3D", "WithinChannelLRN", "WordEmbedding",
           "ZeroPadding1D", "ZeroPadding2D", "ZeroPadding3D"]
