"""ZooModel — port of the ``ZooModel`` facade of ``analytics_zoo_tpu/
models/common/zoo_model.py``: a subclass declares its constructor config
and builds an inner network in ``build_model()``; the facade delegates
the forward pass to it; ``register_model`` names the zoo's classes.
``.npz`` save/load is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

import torch

from ...common.context import get_zoo_context, resolve_device
from ...pipeline.api.keras.engine import KerasNet, load_param_tree

_REGISTRY: Dict[str, Type["ZooModel"]] = {}


def register_model(cls: Type["ZooModel"]) -> Type["ZooModel"]:
    """Class decorator: register a ZooModel by its class name."""
    _REGISTRY[cls.__name__] = cls
    return cls


class ZooModel(KerasNet):
    """Base for built-in models. ``device`` is where the weights live
    (``cuda`` unless given; raises without a GPU). Weights are drawn at
    ``init_weights`` on the CPU from an explicit generator — the same
    seed gives the same weights on every device — then moved."""

    def __init__(self, name: Optional[str] = None, device=None):
        super().__init__(name=name)
        self.device = resolve_device(device)
        self.model = self.build_model()
        self.built = False

    def build_model(self) -> KerasNet:
        raise NotImplementedError(type(self).__name__)

    def get_config(self) -> Dict[str, Any]:
        raise NotImplementedError(type(self).__name__)

    @property
    def input_shape(self):
        return self.model.input_shape

    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "ZooModel":
        """Create every parameter from ``generator`` (default: seeded from
        ``zoo.seed``) and move it to ``self.device``."""
        if generator is None:
            generator = get_zoo_context().generator()
        self.model.build(self.model.input_shape, generator=generator)
        self.to(self.device)
        self.built = self.model.built = True
        return self

    def load_jax_params(self, tree: Dict[str, Any]) -> "ZooModel":
        """Fill the inner network from the JAX model's param tree, name for
        name (the inner network's parameter paths are the tree's); builds
        first if needed."""
        if not self.built:
            self.init_weights()
        load_param_tree(self.model, tree)
        return self

    def call(self, x, *, training=False, generator=None):
        if not self.built:
            raise RuntimeError("no weights; call init_weights() first")
        return self.model(x, training=training, generator=generator)

    def fused_head(self):
        """Fused LM-head loss resolution (``keras/fused_loss.py``) sees
        through the facade to the inner network's logits head."""
        from ...pipeline.api.keras.fused_loss import find_head
        return find_head(self.model)

    def summary(self) -> str:
        n = sum(p.numel() for p in self.parameters())
        return (f"Model: {type(self).__name__} ({self.name})\n"
                f"Trainable parameters: {n:,}")
