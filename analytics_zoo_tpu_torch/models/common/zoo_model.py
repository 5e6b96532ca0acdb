"""ZooModel — port of the ``ZooModel`` facade of ``analytics_zoo_tpu/
models/common/zoo_model.py``: a subclass declares its constructor config
and builds an inner network in ``build_model()``; the facade delegates
the forward pass to it; ``register_model`` names the zoo's classes.

``save(path)`` writes the JAX package's one-file ``.npz``: a
``__zoo_header__`` JSON (class, config, extra, n_params, n_state) and the
weights as ``p_i`` in the JAX ``tree_flatten`` order of the param tree
(sorted keys, depth first), then the model state (a frozen
``WordEmbedding`` table, BatchNorm's statistics; :meth:`Layer.add_state`)
as ``s_i`` in the order of the JAX ``net_state`` tree. Constructor arrays
(:meth:`ZooModel.extra_arrays`) ride as ``x_<kwarg>``, or as a reference
to a saved leaf with the same bits. :func:`load_model` rebuilds the
registered class from the header and installs the weights and the state.
A file written by either package loads into the other; the model state
includes what the training step writes (BatchNorm's moving statistics).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from ...common.context import get_zoo_context, resolve_device
from ...pipeline.api.keras.engine import (KerasNet, load_param_tree,
                                          named_state, tree_order)

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

    def extra_arrays(self) -> Dict[str, np.ndarray]:
        """Constructor kwargs that are arrays (a pretrained embedding
        table): saved beside the weights and handed back on load."""
        return {}

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

    def load_jax_params(self, tree: Dict[str, Any],
                        state: Optional[Dict[str, Any]] = None
                        ) -> "ZooModel":
        """Fill the inner network from the JAX model's param tree (and its
        ``net_state`` tree when given), name for name (the inner network's
        paths are the trees'); builds first if needed."""
        if not self.built:
            self.init_weights()
        load_param_tree(self.model, tree, state)
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

    # ---- save / load (ZooModel.scala:38-154) ------------------------------
    def save(self, path: str, over_write: bool = True) -> str:
        """``saveModel(path, overWrite)``: one ``.npz`` with the config and
        the weights, in the JAX package's format."""
        if not path.endswith(".npz"):
            path += ".npz"
        if os.path.exists(path) and not over_write:
            raise FileExistsError(f"{path} exists and over_write=False")
        if not self.built:
            self.init_weights()
        p_leaves = _host(tree_order(dict(self.model.named_parameters())))
        s_leaves = _host(tree_order(named_state(self.model)))
        arrays = {f"p_{i}": a for i, a in enumerate(p_leaves)}
        arrays.update({f"s_{i}": a for i, a in enumerate(s_leaves)})
        # a constructor array with the bits of a saved leaf (a frozen
        # table in the state) is stored once, as a reference to it
        extra_refs: Dict[str, str] = {}
        for k, v in self.extra_arrays().items():
            v = np.asarray(v)
            ref = next((name for name, a in arrays.items()
                        if a.shape == v.shape and a.dtype == v.dtype
                        and np.array_equal(a, v)), None)
            if ref is None:
                ref = f"x_{k}"
                arrays[ref] = v
            extra_refs[k] = ref
        header = json.dumps({"class": type(self).__name__,
                             "config": self.get_config(),
                             "extra": extra_refs,
                             "n_params": len(p_leaves),
                             "n_state": len(s_leaves)})
        np.savez(path, __zoo_header__=np.frombuffer(
            header.encode("utf-8"), dtype=np.uint8), **arrays)
        return path

    @classmethod
    def load(cls, path: str, device=None) -> "ZooModel":
        return load_model(path, device=device)

    def summary(self) -> str:
        n = sum(p.numel() for p in self.parameters())
        return (f"Model: {type(self).__name__} ({self.name})\n"
                f"Trainable parameters: {n:,}")


def _host(pairs: List[Tuple[str, torch.Tensor]]) -> List[np.ndarray]:
    """Host copies of the whole tensors of ``pairs`` (bf16 widened to
    f32)."""
    from ...parallel.mesh import full_tensor
    out = []
    for _, t in pairs:
        # a parameter placed on a device mesh: the whole array (collective)
        t = full_tensor(t).detach().cpu()
        out.append((t.float() if t.dtype == torch.bfloat16 else t).numpy())
    return out


def _install(pairs: List[Tuple[str, torch.Tensor]], arrays, path: str,
             what: str) -> None:
    if len(pairs) != len(arrays):
        raise ValueError(f"{path} holds {len(arrays)} {what} arrays; the "
                         f"model has {len(pairs)}")
    with torch.no_grad():
        for (name, t), a in zip(pairs, arrays):
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{name}: saved shape {tuple(a.shape)} "
                                 f"does not match {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.asarray(a)).to(t.dtype))


def _populate_registry() -> None:
    """Import the port's model packages so their ``@register_model``
    decorators run — a fresh process may call :func:`load_model` before
    any zoo model module was imported."""
    import importlib
    for mod in ("analytics_zoo_tpu_torch.models.recommendation",
                "analytics_zoo_tpu_torch.models.anomalydetection",
                "analytics_zoo_tpu_torch.models.textclassification",
                "analytics_zoo_tpu_torch.models.textmatching",
                "analytics_zoo_tpu_torch.models.seq2seq",
                "analytics_zoo_tpu_torch.models.image",
                "analytics_zoo_tpu_torch.models.image.objectdetection",
                "analytics_zoo_tpu_torch.tfpark.bert_classifier",
                "analytics_zoo_tpu_torch.tfpark.bert_ner"):
        try:
            importlib.import_module(mod)
        except ImportError as e:  # pragma: no cover - partial installs
            logging.getLogger("analytics_zoo_tpu_torch.models").warning(
                "model package %s failed to import (%s); its classes will "
                "be unavailable to load_model", mod, e)


def load_model(path: str, device=None) -> ZooModel:
    """``ZooModel.loadModel`` (``ZooModel.scala:119-154``): rebuild the
    registered class from the ``.npz`` header on ``device`` (``cuda``
    unless given), then install the saved weights."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as data:
        header = json.loads(bytes(data["__zoo_header__"]).decode("utf-8"))
        p_loaded = [data[f"p_{i}"] for i in range(header["n_params"])]
        s_loaded = [data[f"s_{i}"] for i in range(header.get("n_state", 0))]
        extras = {k: data[ref]
                  for k, ref in header.get("extra", {}).items()}
    cls = _REGISTRY.get(header["class"])
    if cls is None:
        _populate_registry()
        cls = _REGISTRY.get(header["class"])
    if cls is None:
        raise ValueError(f"unknown model class {header['class']!r}; "
                         f"registered: {sorted(_REGISTRY)}")
    model = cls(**header["config"], **extras, device=device)
    model.init_weights()
    _install(tree_order(dict(model.model.named_parameters())), p_loaded,
             path, "weight")
    _install(tree_order(named_state(model.model)), s_loaded, path, "state")
    return model
