"""Fused LM-head loss resolution — port of ``analytics_zoo_tpu/pipeline/
api/keras/fused_loss.py``: wires ``ops/fused_cross_entropy`` into the
training loop without touching model code.

``resolve_fused_loss(model, loss_fn)`` recognizes the (head Dense,
sparse-CE loss) pattern once per training loop and returns a spec that
computes the loss straight from the head's INPUT hidden states: the trunk
runs normally, the head's container dispatch is intercepted to identity
(``engine.intercept_layer_calls``), and the fused blockwise loss consumes
the head's ``W``/``b`` parameters, so the ``(B·T, V)`` logits tensor is
never formed in the training step. Gradients reach the head weights
through the fused autograd Function.

Recognized patterns (``zoo.train.fused_ce``: auto | true | false):

* loss ``scce_with_logits`` + a linear head ``Dense(V)`` — exact fusion;
* loss ``scce`` + a ``Dense(V, activation="softmax")`` head — the exact
  logits-form cross-entropy the clipped probability form approximates;
  only under the EXPLICIT ``zoo.train.fused_ce=true``, since the
  probability form's eps-clip makes saturated losses differ.

``auto`` engages at ``V >= AUTO_MIN_VOCAB``. Heads are found on a
``Sequential`` (its last layer), on a single-output ``Model`` whose output
node is a Dense, or through a ``fused_head() -> (dense, param_path)`` hook
(``BERTClassifier``'s network has one, and the ``ZooModel`` facade sees
through to the inner network). The full-logits objective stays the
oracle: ``evaluate``/
``predict`` and every non-matching model keep it. On a mesh whose
``model`` axis splits the head's columns (its width divides the axis;
``parallel.mesh.param_shardings`` then commits the split) the loss takes
the vocab-sharded form (``ops.fused_cross_entropy.
sharded_fused_sparse_cross_entropy``): each rank streams its ``(chunk,
V/n)`` weight slice and ``dW`` stays on the rank's columns. The spec's
``sharded`` says which form is live.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ....ops.fused_cross_entropy import (AUTO_MIN_VOCAB,
                                         fused_sparse_cross_entropy,
                                         sharded_fused_sparse_cross_entropy,
                                         vocab_shard_count)


def find_head(model) -> Optional[Tuple[object, Tuple[str, ...]]]:
    """``(head_dense_layer, param_path)`` for the model's logits head, or
    None when no unique container-dispatched Dense head exists."""
    from .engine import Model, Sequential
    from .layers.core import Dense

    hook = getattr(model, "fused_head", None)
    if callable(hook):
        return hook()
    if isinstance(model, Sequential) and model.layers:
        head = model.layers[-1]
        if (isinstance(head, Dense)
                and sum(1 for l in model.layers if l is head) == 1):
            return head, (head.name,)
        return None
    if isinstance(model, Model) and len(model.outputs) == 1:
        node = model.outputs[0].node
        if (node.parents and isinstance(node.layer, Dense)
                and sum(1 for n in model._topo if n.layer is node.layer) == 1):
            return node.layer, (node.name,)
    return None


class FusedHeadSpec:
    """A resolved head: applies the trunk (head intercepted to identity)
    and the fused blockwise loss over the head's own parameters."""

    def __init__(self, head, param_path: Tuple[str, ...],
                 sharded: bool = False):
        self.head = head
        self.param_path = tuple(param_path)
        self.sharded = bool(sharded)

    def apply_and_loss(self, model, x, y, *, generator=None) -> torch.Tensor:
        """The training loss with the head fused into it."""
        from .engine import intercept_layer_calls
        head = self.head

        def hook(layer, xx, training, gen):
            return xx if layer is head else None   # expose hidden states

        with intercept_layer_calls(hook):
            h = model(x, training=True, generator=generator)
        w = head.W
        # the oracle's gather wraps a label in [-V, -1] to V + label and
        # keeps the row in the mean; a label outside [-V, V) gives a NaN
        # row. Replicate both: wrap the in-range negatives and send the
        # rest to V, which the op poisons. (Ignore-label masking is the
        # op-level fused_sparse_cross_entropy API.)
        v = head.output_dim
        labels = torch.as_tensor(y, device=h.device).reshape(-1).to(
            torch.int32)
        labels = torch.where(labels < -v, torch.full_like(labels, v),
                             torch.where(labels < 0, labels + v, labels))
        b = head.b if head.bias else None
        if self.sharded:
            return sharded_fused_sparse_cross_entropy(labels, h, w, b)
        return fused_sparse_cross_entropy(labels, h, w, b)


def _mode() -> str:
    from ....common.context import tri_state_conf
    flag = tri_state_conf("zoo.train.fused_ce")
    if flag == "auto":
        return "auto"
    return "on" if flag else "off"


def resolve_fused_loss(model, loss_fn: Callable) -> Optional[FusedHeadSpec]:
    """The spec for (model, loss) when the fused path applies, else None.

    The hidden size does not enter the decision: the CUDA kernels take
    any head input width."""
    from . import objectives
    from .layers.core import ACTIVATIONS

    mode = _mode()
    if mode == "off":
        return None
    found = find_head(model)
    if found is None:
        return None
    head, path = found
    if loss_fn is objectives.sparse_categorical_crossentropy_from_logits:
        # activation="linear" resolves to the registry's identity — the
        # same raw-logits head as activation=None
        if head.activation is not None \
                and head.activation is not ACTIVATIONS["linear"]:
            return None            # activated output: not raw logits
    elif loss_fn is objectives.sparse_categorical_crossentropy:
        if head.activation is not ACTIVATIONS["softmax"]:
            return None            # only softmax probabilities invert to CE
        if mode != "on":
            return None            # the eps-clipped form is approximated
    else:
        return None
    if mode == "auto" and head.output_dim < AUTO_MIN_VOCAB:
        return None
    return FusedHeadSpec(head, path, sharded=_head_sharded(head))


def _head_sharded(head) -> bool:
    """Whether the head's kernel is model-sharded under the current mesh:
    the divisibility ``mesh.param_shardings`` checks before it commits
    the Dense column split (an indivisible head keeps the replicated
    kernel and the unsharded loss together), JAX ``_head_sharded``."""
    n_model = vocab_shard_count()
    return n_model > 1 and head.output_dim % n_model == 0
