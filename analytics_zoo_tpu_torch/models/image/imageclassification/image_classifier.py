"""ImageClassifier — port of ``analytics_zoo_tpu/models/image/
imageclassification/image_classifier.py``; parity with
``models/image/imageclassification/ImageClassifier.scala`` and its published
topologies (``ImageClassificationConfig.scala:34-51``).

Topologies are built with the Keras-style graph API (channels-last NHWC,
the JAX package's layout and layer names):

* ``inception-v1`` — full GoogLeNet (Szegedy et al. 2015): 7x7/2 stem, 9
  inception blocks, global average pool. The reference ships Inception-v1 as
  its flagship published classifier (``examples/inception/Train.scala``).
* ``simple-cnn`` — a small conv stack for tests/transfer-learning demos.

Transfer learning: ``new_head(num_classes)`` swaps the classification head
keeping backbone weights, and ``model.new_graph([...])`` (the
``newGraph(output)`` surgery of ``NetUtils.scala``) cuts the graph at the
pooled features; freeze the backbone by training with a per-submodule
optimizer mapping the backbone prefix to a zero-lr optimizer
(``Estimator(optim_methods={...})``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ....pipeline.api.keras.engine import Input, KerasNet, Model
from ....pipeline.api.keras.layers import (Convolution2D, Dense, Dropout,
                                           GlobalAveragePooling2D,
                                           MaxPooling2D, merge)
from ...common.zoo_model import register_model
from ..common.image_model import ImageModel
from .topologies import (alexnet, densenet_161, inception_v3, mobilenet,
                         mobilenet_v2, resnet_50, squeezenet, vgg_16,
                         vgg_19)

__all__ = ["ImageClassifier", "inception_v1"]


def _conv(x, nb_filter, nb_row, nb_col, subsample=(1, 1), name=None):
    return Convolution2D(nb_filter, nb_row, nb_col, activation="relu",
                         border_mode="same", subsample=subsample,
                         name=name)(x)


def _inception_block(x, c1, c3r, c3, c5r, c5, pp, name):
    """One GoogLeNet inception module: 1x1 / 3x3 / 5x5 / pool-proj branches,
    channel-concat (NHWC => concat_axis=-1)."""
    b1 = _conv(x, c1, 1, 1, name=f"{name}_1x1")
    b3 = _conv(_conv(x, c3r, 1, 1, name=f"{name}_3x3r"), c3, 3, 3,
               name=f"{name}_3x3")
    b5 = _conv(_conv(x, c5r, 1, 1, name=f"{name}_5x5r"), c5, 5, 5,
               name=f"{name}_5x5")
    bp = _conv(MaxPooling2D((3, 3), strides=(1, 1), border_mode="same",
                            name=f"{name}_pool")(x), pp, 1, 1,
               name=f"{name}_proj")
    return merge([b1, b3, b5, bp], "concat", name=f"{name}_out")


def inception_v1(input_shape: Tuple[int, int, int] = (224, 224, 3),
                 num_classes: int = 1000, dropout: float = 0.4,
                 device=None) -> KerasNet:
    """GoogLeNet / Inception-v1 backbone + classifier head (the reference's
    ``examples/inception/Train.scala`` topology), NHWC."""
    inp = Input(shape=input_shape, name="image")
    x = _conv(inp, 64, 7, 7, subsample=(2, 2), name="stem_conv7")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="stem_pool1")(x)
    x = _conv(x, 64, 1, 1, name="stem_conv1")
    x = _conv(x, 192, 3, 3, name="stem_conv3")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="stem_pool2")(x)
    x = _inception_block(x, 64, 96, 128, 16, 32, 32, "inc3a")
    x = _inception_block(x, 128, 128, 192, 32, 96, 64, "inc3b")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="pool3")(x)
    x = _inception_block(x, 192, 96, 208, 16, 48, 64, "inc4a")
    x = _inception_block(x, 160, 112, 224, 24, 64, 64, "inc4b")
    x = _inception_block(x, 128, 128, 256, 24, 64, 64, "inc4c")
    x = _inception_block(x, 112, 144, 288, 32, 64, 64, "inc4d")
    x = _inception_block(x, 256, 160, 320, 32, 128, 128, "inc4e")
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same",
                     name="pool4")(x)
    x = _inception_block(x, 256, 160, 320, 32, 128, 128, "inc5a")
    x = _inception_block(x, 384, 192, 384, 48, 128, 128, "inc5b")
    x = GlobalAveragePooling2D(name="gap")(x)
    x = Dropout(dropout, name="head_dropout")(x)
    out = Dense(num_classes, activation="softmax", name="head_dense")(x)
    return Model(inp, out, device=device)


def _simple_cnn(input_shape, num_classes, dropout, device=None):
    inp = Input(shape=input_shape, name="image")
    x = _conv(inp, 16, 3, 3, name="backbone_conv1")
    x = MaxPooling2D((2, 2), name="backbone_pool1")(x)
    x = _conv(x, 32, 3, 3, name="backbone_conv2")
    x = MaxPooling2D((2, 2), name="backbone_pool2")(x)
    x = GlobalAveragePooling2D(name="backbone_gap")(x)
    x = Dropout(dropout, name="head_dropout")(x)
    out = Dense(num_classes, activation="softmax", name="head_dense")(x)
    return Model(inp, out, device=device)


_TOPOLOGIES = {
    "inception-v1": inception_v1,
    "simple-cnn": _simple_cnn,
    "alexnet": alexnet,
    "inception-v3": inception_v3,
    "resnet-50": resnet_50,
    "vgg-16": vgg_16,
    "vgg-19": vgg_19,
    "densenet-161": densenet_161,
    "squeezenet": squeezenet,
    "mobilenet": mobilenet,
    "mobilenet-v2": mobilenet_v2,
}


@register_model
class ImageClassifier(ImageModel):
    """``ImageClassifier(model, topology)``
    (``ImageClassifier.scala`` + config registry
    ``ImageClassificationConfig.scala:34-51``). ``device`` is where the
    weights live (``cuda`` unless given)."""

    def __init__(self, model_name: str = "inception-v1",
                 num_classes: int = 1000,
                 input_shape: Tuple[int, int, int] = (224, 224, 3),
                 dropout: float = 0.4, name: Optional[str] = None,
                 device=None):
        # "-quantize"/"-int8" suffixed registry names
        # (ImageClassificationConfig.scala) share the float graph; the
        # precision lives in the inference runtime (as_inference_model)
        base = model_name
        self.quantize: Optional[str] = None
        for suffix in ("-quantize", "-int8"):
            if base.endswith(suffix):
                base = base[:-len(suffix)]
                self.quantize = "int8"
        if base not in _TOPOLOGIES:
            raise ValueError(f"unknown topology {model_name!r}; "
                             f"available: {sorted(_TOPOLOGIES)} "
                             f"(+ '-quantize'/'-int8' suffixes)")
        self._base_name = base
        self.model_name = model_name
        self.num_classes = int(num_classes)
        self._input_shape = tuple(int(d) for d in input_shape)
        self.dropout = float(dropout)
        super().__init__(name=name, device=device)

    def build_model(self) -> KerasNet:
        return _TOPOLOGIES[self._base_name](
            input_shape=self._input_shape, num_classes=self.num_classes,
            dropout=self.dropout, device=self.device)

    def as_inference_model(self, concurrent_num: int = 1):
        """The serving-side counterpart: wrap the (trained) classifier in an
        InferenceModel on this model's device; ``*-quantize``/``*-int8``
        names load int8 weight-only quantized."""
        from ....pipeline.inference import InferenceModel
        return InferenceModel(concurrent_num, device=self.device).from_keras(
            self, quantize=self.quantize)

    def get_config(self) -> Dict[str, Any]:
        return {"model_name": self.model_name,
                "num_classes": self.num_classes,
                "input_shape": list(self._input_shape),
                "dropout": self.dropout}

    # ---- transfer learning (NetUtils.scala newGraph role) -----------------
    def new_head(self, num_classes: int) -> "ImageClassifier":
        """Re-head for fine-tuning: keep every backbone weight, replace the
        class-count-dependent head. Grafting is shape-aware — a donor layer
        is copied only when its whole parameter set matches the clone's
        freshly-built names and shapes, so heads named ``fc8``/``conv10``/
        ``head_dense`` alike keep their fresh init when ``num_classes``
        changes. The model state (BatchNorm's statistics) is the clone's
        fresh one, as in the JAX package. The returned model shares no
        tensors with ``self``."""
        clone = ImageClassifier(self.model_name, num_classes,
                                self._input_shape, self.dropout,
                                device=self.device)
        clone.init_weights()
        if self.built:
            donor = dict(self.model.named_children())
            with torch.no_grad():
                for k, layer in clone.model.named_children():
                    mine = dict(layer.named_parameters())
                    theirs = (dict(donor[k].named_parameters())
                              if k in donor else None)
                    if not mine or theirs is None or {
                            n: tuple(p.shape) for n, p in mine.items()} != {
                            n: tuple(p.shape) for n, p in theirs.items()}:
                        continue
                    for n, p in mine.items():
                        p.copy_(theirs[n])
        return clone
