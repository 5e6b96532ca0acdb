"""Published classifier topologies — port of ``analytics_zoo_tpu/models/
image/imageclassification/topologies.py``, parity with the reference's registry
(``models/image/imageclassification/ImageClassificationConfig.scala:34-51``:
alexnet, inception-v1/v3, resnet-50, vgg-16/19, densenet-161, squeezenet,
mobilenet, mobilenet-v2; the ``-quantize``/``-int8`` suffixes are handled
by the inference runtime's weight quantization, not separate graphs).

All topologies are NHWC graphs over the port's layer set, with the JAX
package's layer names, so ``load_jax_params`` moves a JAX model's params
and BatchNorm state across name for name; each function takes
``(input_shape, num_classes, dropout)`` (and ``device``, where the weights
live) and returns a ``KerasNet`` so the :class:`ImageClassifier` registry
can build any of them uniformly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ....pipeline.api.keras.engine import Input, Model
from ....pipeline.api.keras.layers import (Activation, AveragePooling2D,
                                           BatchNormalization, Convolution2D,
                                           Dense, DepthwiseConvolution2D,
                                           Dropout, Flatten,
                                           GlobalAveragePooling2D,
                                           MaxPooling2D, merge)

__all__ = ["alexnet", "vgg_16", "vgg_19", "resnet_50", "squeezenet",
           "mobilenet", "mobilenet_v2", "densenet_161", "inception_v3"]


def _conv(x, nf, k, name, stride=(1, 1), border="same", act="relu"):
    return Convolution2D(nf, k, k, subsample=stride, activation=act,
                         border_mode=border, name=name)(x)


def _conv_bn(x, nf, kr, kc, name, stride=(1, 1), border="same"):
    x = Convolution2D(nf, kr, kc, subsample=stride, border_mode=border,
                      bias=False, name=name)(x)
    x = BatchNormalization(name=f"{name}_bn")(x)
    return Activation("relu", name=f"{name}_relu")(x)


def _head(x, num_classes, dropout, name="head"):
    x = GlobalAveragePooling2D(name=f"{name}_gap")(x)
    if dropout:
        x = Dropout(dropout, name=f"{name}_dropout")(x)
    return Dense(num_classes, activation="softmax", name=f"{name}_dense")(x)


# ---------------------------------------------------------------------------
# AlexNet / VGG
# ---------------------------------------------------------------------------

def alexnet(input_shape=(227, 227, 3), num_classes=1000, dropout=0.5,
            device=None):
    inp = Input(shape=input_shape, name="image")
    x = _conv(inp, 96, 11, "conv1", stride=(4, 4), border="valid")
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool1")(x)
    x = _conv(x, 256, 5, "conv2")
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool2")(x)
    x = _conv(x, 384, 3, "conv3")
    x = _conv(x, 384, 3, "conv4")
    x = _conv(x, 256, 3, "conv5")
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool5")(x)
    x = Flatten(name="flatten")(x)
    x = Dense(4096, activation="relu", name="fc6")(x)
    x = Dropout(dropout, name="drop6")(x)
    x = Dense(4096, activation="relu", name="fc7")(x)
    x = Dropout(dropout, name="drop7")(x)
    out = Dense(num_classes, activation="softmax", name="fc8")(x)
    return Model(inp, out, device=device)


def _vgg(blocks: Sequence[int], input_shape, num_classes, dropout, device):
    inp = Input(shape=input_shape, name="image")
    x = inp
    filters = (64, 128, 256, 512, 512)
    for b, (n, nf) in enumerate(zip(blocks, filters), start=1):
        for i in range(n):
            x = _conv(x, nf, 3, f"conv{b}_{i + 1}")
        x = MaxPooling2D((2, 2), name=f"pool{b}")(x)
    x = Flatten(name="flatten")(x)
    x = Dense(4096, activation="relu", name="fc6")(x)
    x = Dropout(dropout, name="drop6")(x)
    x = Dense(4096, activation="relu", name="fc7")(x)
    x = Dropout(dropout, name="drop7")(x)
    out = Dense(num_classes, activation="softmax", name="fc8")(x)
    return Model(inp, out, device=device)


def vgg_16(input_shape=(224, 224, 3), num_classes=1000, dropout=0.5,
           device=None):
    return _vgg((2, 2, 3, 3, 3), input_shape, num_classes, dropout, device)


def vgg_19(input_shape=(224, 224, 3), num_classes=1000, dropout=0.5,
           device=None):
    return _vgg((2, 2, 4, 4, 4), input_shape, num_classes, dropout, device)


# ---------------------------------------------------------------------------
# ResNet-50
# ---------------------------------------------------------------------------

def _bottleneck(x, nf, name, stride=(1, 1), project=False):
    sc = x
    if project:
        sc = Convolution2D(nf * 4, 1, 1, subsample=stride, border_mode="same",
                           bias=False, name=f"{name}_proj")(x)
        sc = BatchNormalization(name=f"{name}_proj_bn")(sc)
    y = _conv_bn(x, nf, 1, 1, f"{name}_a", stride=stride)
    y = _conv_bn(y, nf, 3, 3, f"{name}_b")
    y = Convolution2D(nf * 4, 1, 1, border_mode="same", bias=False,
                      name=f"{name}_c")(y)
    y = BatchNormalization(name=f"{name}_c_bn")(y)
    out = merge([y, sc], "sum", name=f"{name}_add")
    return Activation("relu", name=f"{name}_out")(out)


def resnet_50(input_shape=(224, 224, 3), num_classes=1000, dropout=0.0,
              device=None):
    inp = Input(shape=input_shape, name="image")
    x = _conv_bn(inp, 64, 7, 7, "conv1", stride=(2, 2))
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="pool1")(x)
    for stage, (nf, n, stride) in enumerate(
            [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)], start=2):
        for block in range(n):
            s = (stride, stride) if block == 0 else (1, 1)
            x = _bottleneck(x, nf, f"res{stage}{chr(97 + block)}",
                            stride=s, project=(block == 0))
    return Model(inp, _head(x, num_classes, dropout), device=device)


# ---------------------------------------------------------------------------
# SqueezeNet
# ---------------------------------------------------------------------------

def _fire(x, squeeze, expand, name):
    s = _conv(x, squeeze, 1, f"{name}_squeeze")
    e1 = _conv(s, expand, 1, f"{name}_e1")
    e3 = _conv(s, expand, 3, f"{name}_e3")
    return merge([e1, e3], "concat", concat_axis=-1, name=f"{name}_out")


def squeezenet(input_shape=(224, 224, 3), num_classes=1000, dropout=0.5,
               device=None):
    inp = Input(shape=input_shape, name="image")
    x = _conv(inp, 64, 3, "conv1", stride=(2, 2))
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool1")(x)
    x = _fire(x, 16, 64, "fire2")
    x = _fire(x, 16, 64, "fire3")
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool3")(x)
    x = _fire(x, 32, 128, "fire4")
    x = _fire(x, 32, 128, "fire5")
    x = MaxPooling2D((3, 3), strides=(2, 2), name="pool5")(x)
    x = _fire(x, 48, 192, "fire6")
    x = _fire(x, 48, 192, "fire7")
    x = _fire(x, 64, 256, "fire8")
    x = _fire(x, 64, 256, "fire9")
    if dropout:
        x = Dropout(dropout, name="drop9")(x)
    x = _conv(x, num_classes, 1, "conv10")
    x = GlobalAveragePooling2D(name="gap")(x)
    return Model(inp, Activation("softmax", name="probs")(x), device=device)


# ---------------------------------------------------------------------------
# MobileNet v1 / v2
# ---------------------------------------------------------------------------

def _dw_bn(x, name, stride=(1, 1)):
    x = DepthwiseConvolution2D(3, 3, subsample=stride, border_mode="same",
                               bias=False, name=name)(x)
    x = BatchNormalization(name=f"{name}_bn")(x)
    return Activation("relu", name=f"{name}_relu")(x)


def mobilenet(input_shape=(224, 224, 3), num_classes=1000, dropout=0.001,
              alpha: float = 1.0, device=None):
    inp = Input(shape=input_shape, name="image")
    x = _conv_bn(inp, int(32 * alpha), 3, 3, "conv1", stride=(2, 2))
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1)]
    for i, (nf, s) in enumerate(plan, start=1):
        x = _dw_bn(x, f"dw{i}", stride=(s, s))
        x = _conv_bn(x, int(nf * alpha), 1, 1, f"pw{i}")
    return Model(inp, _head(x, num_classes, dropout), device=device)


def _inverted_residual(x, in_ch, nf, name, stride=1, expand=6):
    h = x
    if expand != 1:
        h = _conv_bn(h, in_ch * expand, 1, 1, f"{name}_expand")
    h = DepthwiseConvolution2D(3, 3, subsample=(stride, stride),
                               border_mode="same", bias=False,
                               name=f"{name}_dw")(h)
    h = BatchNormalization(name=f"{name}_dw_bn")(h)
    h = Activation("relu", name=f"{name}_dw_relu")(h)
    h = Convolution2D(nf, 1, 1, border_mode="same", bias=False,
                      name=f"{name}_project")(h)
    h = BatchNormalization(name=f"{name}_project_bn")(h)
    if stride == 1 and in_ch == nf:
        return merge([x, h], "sum", name=f"{name}_add")
    return h


def mobilenet_v2(input_shape=(224, 224, 3), num_classes=1000, dropout=0.2,
                 device=None):
    inp = Input(shape=input_shape, name="image")
    x = _conv_bn(inp, 32, 3, 3, "conv1", stride=(2, 2))
    in_ch = 32
    plan = [  # (expansion, out_ch, repeats, first-stride)
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    b = 0
    for t, c, n, s in plan:
        for i in range(n):
            x = _inverted_residual(x, in_ch, c, f"block{b}",
                                   stride=(s if i == 0 else 1), expand=t)
            in_ch = c
            b += 1
    x = _conv_bn(x, 1280, 1, 1, "conv_last")
    return Model(inp, _head(x, num_classes, dropout), device=device)


# ---------------------------------------------------------------------------
# DenseNet-161
# ---------------------------------------------------------------------------

def _dense_block(x, n_layers, growth, name):
    for i in range(n_layers):
        h = BatchNormalization(name=f"{name}_{i}_bn1")(x)
        h = Activation("relu", name=f"{name}_{i}_relu1")(h)
        h = Convolution2D(4 * growth, 1, 1, border_mode="same", bias=False,
                          name=f"{name}_{i}_conv1")(h)
        h = BatchNormalization(name=f"{name}_{i}_bn2")(h)
        h = Activation("relu", name=f"{name}_{i}_relu2")(h)
        h = Convolution2D(growth, 3, 3, border_mode="same", bias=False,
                          name=f"{name}_{i}_conv2")(h)
        x = merge([x, h], "concat", concat_axis=-1, name=f"{name}_{i}_cat")
    return x


def _transition(x, out_ch, name):
    x = BatchNormalization(name=f"{name}_bn")(x)
    x = Activation("relu", name=f"{name}_relu")(x)
    x = Convolution2D(out_ch, 1, 1, border_mode="same", bias=False,
                      name=f"{name}_conv")(x)
    return AveragePooling2D((2, 2), name=f"{name}_pool")(x)


def densenet_161(input_shape=(224, 224, 3), num_classes=1000, dropout=0.0,
                 growth: int = 48,
                 blocks: Tuple[int, ...] = (6, 12, 36, 24), device=None):
    inp = Input(shape=input_shape, name="image")
    ch = 2 * growth
    x = _conv_bn(inp, ch, 7, 7, "conv1", stride=(2, 2))
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="pool1")(x)
    for bi, n in enumerate(blocks):
        x = _dense_block(x, n, growth, f"dense{bi + 2}")
        ch += n * growth
        if bi != len(blocks) - 1:
            ch //= 2
            x = _transition(x, ch, f"trans{bi + 2}")
    x = BatchNormalization(name="final_bn")(x)
    x = Activation("relu", name="final_relu")(x)
    return Model(inp, _head(x, num_classes, dropout), device=device)


# ---------------------------------------------------------------------------
# Inception-v3
# ---------------------------------------------------------------------------

def _inc3_a(x, pool_proj, name):
    b1 = _conv_bn(x, 64, 1, 1, f"{name}_1x1")
    b2 = _conv_bn(_conv_bn(x, 48, 1, 1, f"{name}_5x5r"), 64, 5, 5,
                  f"{name}_5x5")
    b3 = _conv_bn(_conv_bn(_conv_bn(x, 64, 1, 1, f"{name}_3x3r"),
                           96, 3, 3, f"{name}_3x3a"), 96, 3, 3,
                  f"{name}_3x3b")
    bp = AveragePooling2D((3, 3), strides=(1, 1), border_mode="same",
                          name=f"{name}_avg")(x)
    bp = _conv_bn(bp, pool_proj, 1, 1, f"{name}_pool")
    return merge([b1, b2, b3, bp], "concat", name=f"{name}_out")


def _inc3_b(x, c7, name):
    b1 = _conv_bn(x, 192, 1, 1, f"{name}_1x1")
    b2 = _conv_bn(x, c7, 1, 1, f"{name}_7x7r")
    b2 = _conv_bn(b2, c7, 1, 7, f"{name}_1x7a")
    b2 = _conv_bn(b2, 192, 7, 1, f"{name}_7x1a")
    b3 = _conv_bn(x, c7, 1, 1, f"{name}_d7r")
    b3 = _conv_bn(b3, c7, 7, 1, f"{name}_d7a")
    b3 = _conv_bn(b3, c7, 1, 7, f"{name}_d7b")
    b3 = _conv_bn(b3, c7, 7, 1, f"{name}_d7c")
    b3 = _conv_bn(b3, 192, 1, 7, f"{name}_d7d")
    bp = AveragePooling2D((3, 3), strides=(1, 1), border_mode="same",
                          name=f"{name}_avg")(x)
    bp = _conv_bn(bp, 192, 1, 1, f"{name}_pool")
    return merge([b1, b2, b3, bp], "concat", name=f"{name}_out")


def _inc3_c(x, name):
    b1 = _conv_bn(x, 320, 1, 1, f"{name}_1x1")
    b2 = _conv_bn(x, 384, 1, 1, f"{name}_3x3r")
    b2a = _conv_bn(b2, 384, 1, 3, f"{name}_1x3")
    b2b = _conv_bn(b2, 384, 3, 1, f"{name}_3x1")
    b3 = _conv_bn(_conv_bn(x, 448, 1, 1, f"{name}_d3r"), 384, 3, 3,
                  f"{name}_d3a")
    b3a = _conv_bn(b3, 384, 1, 3, f"{name}_d1x3")
    b3b = _conv_bn(b3, 384, 3, 1, f"{name}_d3x1")
    bp = AveragePooling2D((3, 3), strides=(1, 1), border_mode="same",
                          name=f"{name}_avg")(x)
    bp = _conv_bn(bp, 192, 1, 1, f"{name}_pool")
    return merge([b1, b2a, b2b, b3a, b3b, bp], "concat", name=f"{name}_out")


def inception_v3(input_shape=(299, 299, 3), num_classes=1000, dropout=0.2,
                 device=None):
    inp = Input(shape=input_shape, name="image")
    x = _conv_bn(inp, 32, 3, 3, "stem1", stride=(2, 2), border="valid")
    x = _conv_bn(x, 32, 3, 3, "stem2", border="valid")
    x = _conv_bn(x, 64, 3, 3, "stem3")
    x = MaxPooling2D((3, 3), strides=(2, 2), name="stem_pool1")(x)
    x = _conv_bn(x, 80, 1, 1, "stem4", border="valid")
    x = _conv_bn(x, 192, 3, 3, "stem5", border="valid")
    x = MaxPooling2D((3, 3), strides=(2, 2), name="stem_pool2")(x)
    x = _inc3_a(x, 32, "mixed0")
    x = _inc3_a(x, 64, "mixed1")
    x = _inc3_a(x, 64, "mixed2")
    # reduction A
    r1 = _conv_bn(x, 384, 3, 3, "mixed3_3x3", stride=(2, 2), border="valid")
    r2 = _conv_bn(_conv_bn(_conv_bn(x, 64, 1, 1, "mixed3_d3r"),
                           96, 3, 3, "mixed3_d3a"),
                  96, 3, 3, "mixed3_d3b", stride=(2, 2), border="valid")
    rp = MaxPooling2D((3, 3), strides=(2, 2), name="mixed3_pool")(x)
    x = merge([r1, r2, rp], "concat", name="mixed3_out")
    x = _inc3_b(x, 128, "mixed4")
    x = _inc3_b(x, 160, "mixed5")
    x = _inc3_b(x, 160, "mixed6")
    x = _inc3_b(x, 192, "mixed7")
    # reduction B
    r1 = _conv_bn(_conv_bn(x, 192, 1, 1, "mixed8_3x3r"), 320, 3, 3,
                  "mixed8_3x3", stride=(2, 2), border="valid")
    r2 = _conv_bn(x, 192, 1, 1, "mixed8_7x7r")
    r2 = _conv_bn(r2, 192, 1, 7, "mixed8_1x7")
    r2 = _conv_bn(r2, 192, 7, 1, "mixed8_7x1")
    r2 = _conv_bn(r2, 192, 3, 3, "mixed8_3x3b", stride=(2, 2),
                  border="valid")
    rp = MaxPooling2D((3, 3), strides=(2, 2), name="mixed8_pool")(x)
    x = merge([r1, r2, rp], "concat", name="mixed8_out")
    x = _inc3_c(x, "mixed9")
    x = _inc3_c(x, "mixed10")
    return Model(inp, _head(x, num_classes, dropout), device=device)
