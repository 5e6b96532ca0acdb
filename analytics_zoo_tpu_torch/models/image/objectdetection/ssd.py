"""SSD topologies — port of ``analytics_zoo_tpu/models/image/
objectdetection/ssd.py``; parity with ``objectdetection/ssd/SSD.scala``
(SSDVGG: VGG16 backbone with a conv4_3 L2-norm+scale feature, atrous
fc6/fc7, extra feature layers, shared-location multibox heads) built with
the NHWC Keras-style graph API under the JAX layer names, so
``load_jax_params`` carries the weights across by name.

The model outputs ONE tensor ``(B, n_priors, 4 + num_classes)`` — loc
offsets concatenated with class logits — which
:class:`~.multibox_loss.MultiBoxLoss` consumes directly and
``ObjectDetector`` post-processes with ``batched_detection_output``.

``ssd_lite`` is a small 2-feature-map variant of the same head structure
for tests and small datasets.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ....pipeline.api.keras.engine import Input, KerasNet, Lambda, Model
from ....pipeline.api.keras.layers import (AtrousConvolution2D,
                                           Convolution2D, L2Normalize,
                                           MaxPooling2D, Scale, merge)
from .priors import PriorBox, SSD300_PASCAL_SIZES, ssd_priors

__all__ = ["ssd_vgg", "ssd_lite"]


def _conv(x, nf, k, name, stride=(1, 1), border="same", activation="relu",
          dilation=None):
    if dilation:
        return AtrousConvolution2D(nf, k, k, atrous_rate=(dilation, dilation),
                                   activation=activation, border_mode=border,
                                   name=name)(x)
    return Convolution2D(nf, k, k, subsample=stride, activation=activation,
                         border_mode=border, name=name)(x)


def _heads(features, num_priors_per_map: Sequence[int], num_classes: int):
    """Shared-location loc/conf conv heads; returns the fused
    (B, n_priors, 4+C) output node."""
    locs, confs = [], []
    for i, (feat, k) in enumerate(zip(features, num_priors_per_map)):
        loc = Convolution2D(k * 4, 3, 3, border_mode="same",
                            name=f"mbox{i}_loc")(feat)
        conf = Convolution2D(k * num_classes, 3, 3, border_mode="same",
                             name=f"mbox{i}_conf")(feat)
        locs.append(Lambda(lambda t: t.reshape(t.shape[0], -1, 4),
                           name=f"mbox{i}_loc_flat")(loc))
        confs.append(Lambda(
            lambda t, c=num_classes: t.reshape(t.shape[0], -1, c),
            name=f"mbox{i}_conf_flat")(conf))
    loc_all = (merge(locs, "concat", concat_axis=1, name="mbox_loc")
               if len(locs) > 1 else locs[0])
    conf_all = (merge(confs, "concat", concat_axis=1, name="mbox_conf")
                if len(confs) > 1 else confs[0])
    return merge([loc_all, conf_all], "concat", concat_axis=2, name="mbox")


def ssd_vgg(num_classes: int, resolution: int = 300,
            sizes: Sequence[float] = SSD300_PASCAL_SIZES, device=None
            ) -> Tuple[KerasNet, np.ndarray]:
    """SSD300-VGG16 (``SSDVGG.build``, pascal config). Returns
    ``(model, priors)`` — priors are the host-side constant the loss and
    postprocessor close over."""
    if resolution != 300:
        raise ValueError("only the 300x300 config is built in; pass a "
                         "custom topology for 512")
    inp = Input(shape=(resolution, resolution, 3), name="image")
    x = _conv(inp, 64, 3, "conv1_1")
    x = _conv(x, 64, 3, "conv1_2")
    x = MaxPooling2D((2, 2), name="pool1")(x)
    x = _conv(x, 128, 3, "conv2_1")
    x = _conv(x, 128, 3, "conv2_2")
    x = MaxPooling2D((2, 2), name="pool2")(x)
    x = _conv(x, 256, 3, "conv3_1")
    x = _conv(x, 256, 3, "conv3_2")
    x = _conv(x, 256, 3, "conv3_3")
    x = MaxPooling2D((2, 2), border_mode="same", name="pool3")(x)  # 38
    x = _conv(x, 512, 3, "conv4_1")
    x = _conv(x, 512, 3, "conv4_2")
    conv4_3 = _conv(x, 512, 3, "conv4_3")
    # conv4_3 feature: channelwise L2 normalize + learned scale (init 20)
    f0 = L2Normalize(axis=-1, name="conv4_3_norm")(conv4_3)
    f0 = Scale((512,), init_weight=20.0, name="conv4_3_scale")(f0)
    x = MaxPooling2D((2, 2), name="pool4")(conv4_3)  # 19
    x = _conv(x, 512, 3, "conv5_1")
    x = _conv(x, 512, 3, "conv5_2")
    x = _conv(x, 512, 3, "conv5_3")
    x = MaxPooling2D((3, 3), strides=(1, 1), border_mode="same",
                     name="pool5")(x)
    x = _conv(x, 1024, 3, "fc6", dilation=6)         # atrous fc6
    f1 = _conv(x, 1024, 1, "fc7")                    # 19
    x = _conv(f1, 256, 1, "conv6_1")
    f2 = _conv(x, 512, 3, "conv6_2", stride=(2, 2))  # 10
    x = _conv(f2, 128, 1, "conv7_1")
    f3 = _conv(x, 256, 3, "conv7_2", stride=(2, 2))  # 5
    x = _conv(f3, 128, 1, "conv8_1")
    f4 = _conv(x, 256, 3, "conv8_2", border="valid")  # 3
    x = _conv(f4, 128, 1, "conv9_1")
    f5 = _conv(x, 256, 3, "conv9_2", border="valid")  # 1

    features = [f0, f1, f2, f3, f4, f5]
    feat_shapes = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
    s = list(sizes)
    prior_specs = [
        PriorBox(s[0], s[1], aspect_ratios=(2.0,)),
        PriorBox(s[1], s[2], aspect_ratios=(2.0, 3.0)),
        PriorBox(s[2], s[3], aspect_ratios=(2.0, 3.0)),
        PriorBox(s[3], s[4], aspect_ratios=(2.0, 3.0)),
        PriorBox(s[4], s[5], aspect_ratios=(2.0,)),
        PriorBox(s[5], s[6], aspect_ratios=(2.0,)),
    ]
    out = _heads(features, [p.num_priors for p in prior_specs], num_classes)
    priors = ssd_priors(feat_shapes, prior_specs, float(resolution))
    return Model(inp, out, device=device), priors


def ssd_lite(num_classes: int, resolution: int = 64,
             base_filters: int = 16, device=None
             ) -> Tuple[KerasNet, np.ndarray]:
    """Small SSD with the same head/prior/loss structure: conv stack to two
    feature maps (res/8 and res/16)."""
    inp = Input(shape=(resolution, resolution, 3), name="image")
    x = _conv(inp, base_filters, 3, "c1")
    x = MaxPooling2D((2, 2), name="p1")(x)
    x = _conv(x, base_filters * 2, 3, "c2")
    x = MaxPooling2D((2, 2), name="p2")(x)
    x = _conv(x, base_filters * 4, 3, "c3")
    f0 = MaxPooling2D((2, 2), name="p3")(x)          # res/8
    f1 = _conv(f0, base_filters * 8, 3, "c4", stride=(2, 2))  # res/16

    g0, g1 = resolution // 8, resolution // 16
    prior_specs = [
        PriorBox(resolution * 0.2, resolution * 0.4, aspect_ratios=(2.0,)),
        PriorBox(resolution * 0.5, resolution * 0.8, aspect_ratios=(2.0,)),
    ]
    out = _heads([f0, f1], [p.num_priors for p in prior_specs], num_classes)
    priors = ssd_priors([(g0, g0), (g1, g1)], prior_specs, float(resolution))
    return Model(inp, out, device=device), priors
