"""Loss functions — port of ``analytics_zoo_tpu/pipeline/api/keras/
objectives.py`` (the reference's 15 objectives).

Every loss has two forms, as in the JAX package:

* ``fn(y_true, y_pred) -> scalar`` — mean over the batch (the training
  path);
* a per-example form ``(y_true, y_pred) -> (B,)`` (``fn.per_example``)
  that ``evaluate`` uses to mask padded tail rows out of the statistics.

All computed in float32 whatever the compute dtype. Integer labels follow
JAX's gather rather than ``torch.gather``'s raise: a label in ``[-C, 0)``
wraps once and any other label outside ``[0, C)`` gives a NaN loss for its
row; float labels truncate toward zero (``astype(int32)``).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

_EPS = 1e-7


def _f32(y_true, y_pred):
    y_pred = torch.as_tensor(y_pred).float()
    return torch.as_tensor(y_true, device=y_pred.device).float(), y_pred


def _per_example(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes → shape (B,)."""
    if x.dim() <= 1:
        return x.reshape(-1)
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def _labels(y_true, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(y_true, device=y_pred.device).to(
        torch.int32).reshape(y_pred.shape[:-1])


def _pick(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(logp, labels[..., None], -1)[..., 0]`` with JAX's
    out-of-bounds rule (see the module docstring)."""
    c = logp.shape[-1]
    labels = labels.long()
    labels = torch.where(labels < 0, labels + c, labels)
    valid = (labels >= 0) & (labels < c)
    picked = torch.gather(logp, -1, labels.clamp(0, c - 1)[..., None])[..., 0]
    return torch.where(valid, picked,
                       torch.full((), float("nan"), device=logp.device))


# ---------------------------------------------------------------------------
# per-example forms
# ---------------------------------------------------------------------------

def mean_squared_error_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    return _per_example(torch.square(y_pred - y_true))


def mean_absolute_error_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    return _per_example(torch.abs(y_pred - y_true))


def mean_absolute_percentage_error_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    diff = torch.abs((y_true - y_pred) / torch.clamp(torch.abs(y_true),
                                                     min=_EPS))
    return 100.0 * _per_example(diff)


def mean_squared_logarithmic_error_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    a = torch.log(torch.clamp(y_pred, min=_EPS) + 1.0)
    b = torch.log(torch.clamp(y_true, min=_EPS) + 1.0)
    return _per_example(torch.square(a - b))


def binary_crossentropy_pe(y_true, y_pred):
    """Probability-space BCE (the model emits sigmoid outputs)."""
    y_true, y_pred = _f32(y_true, y_pred)
    p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
    return _per_example(-(y_true * torch.log(p)
                          + (1.0 - y_true) * torch.log1p(-p)))


def binary_crossentropy_from_logits_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    return _per_example(torch.clamp(y_pred, min=0) - y_pred * y_true
                        + torch.log1p(torch.exp(-torch.abs(y_pred))))


def categorical_crossentropy_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    p = torch.clamp(y_pred, _EPS, 1.0)
    return _per_example(-torch.sum(y_true * torch.log(p), dim=-1))


def categorical_crossentropy_from_logits_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    logp = torch.log_softmax(y_pred, dim=-1)
    return _per_example(-torch.sum(y_true * logp, dim=-1))


def sparse_categorical_crossentropy_pe(y_true, y_pred):
    """Integer (0-based) labels against probabilities, clipped to
    ``[_EPS, 1]`` before the log."""
    y_pred = torch.as_tensor(y_pred).float()
    p = torch.clamp(y_pred, _EPS, 1.0)
    return _per_example(-_pick(torch.log(p), _labels(y_true, y_pred)))


def sparse_categorical_crossentropy_from_logits_pe(y_true, y_pred):
    y_pred = torch.as_tensor(y_pred).float()
    logp = torch.log_softmax(y_pred, dim=-1)
    return _per_example(-_pick(logp, _labels(y_true, y_pred)))


def hinge_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    return _per_example(torch.clamp(1.0 - y_true * y_pred, min=0.0))


def squared_hinge_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    return _per_example(torch.square(torch.clamp(1.0 - y_true * y_pred,
                                                 min=0.0)))


def kullback_leibler_divergence_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    p = torch.clamp(y_true, _EPS, 1.0)
    q = torch.clamp(y_pred, _EPS, 1.0)
    return _per_example(torch.sum(p * torch.log(p / q), dim=-1))


def poisson_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    return _per_example(y_pred - y_true * torch.log(y_pred + _EPS))


def cosine_proximity_pe(y_true, y_pred):
    y_true, y_pred = _f32(y_true, y_pred)
    t = y_true / (torch.linalg.vector_norm(y_true, dim=-1, keepdim=True)
                  + _EPS)
    p = y_pred / (torch.linalg.vector_norm(y_pred, dim=-1, keepdim=True)
                  + _EPS)
    return _per_example(-torch.sum(t * p, dim=-1))


# ---------------------------------------------------------------------------
# scalar (batch-mean) forms — the training-path API
# ---------------------------------------------------------------------------

def _scalarize(pe_fn):
    def fn(y_true, y_pred):
        return torch.mean(pe_fn(y_true, y_pred))
    fn.__name__ = pe_fn.__name__[:-3]
    fn.per_example = pe_fn
    return fn


mean_squared_error = _scalarize(mean_squared_error_pe)
mean_absolute_error = _scalarize(mean_absolute_error_pe)
mean_absolute_percentage_error = _scalarize(mean_absolute_percentage_error_pe)
mean_squared_logarithmic_error = _scalarize(mean_squared_logarithmic_error_pe)
binary_crossentropy = _scalarize(binary_crossentropy_pe)
binary_crossentropy_from_logits = _scalarize(
    binary_crossentropy_from_logits_pe)
categorical_crossentropy = _scalarize(categorical_crossentropy_pe)
categorical_crossentropy_from_logits = _scalarize(
    categorical_crossentropy_from_logits_pe)
sparse_categorical_crossentropy = _scalarize(
    sparse_categorical_crossentropy_pe)
sparse_categorical_crossentropy_from_logits = _scalarize(
    sparse_categorical_crossentropy_from_logits_pe)
hinge = _scalarize(hinge_pe)
squared_hinge = _scalarize(squared_hinge_pe)
kullback_leibler_divergence = _scalarize(kullback_leibler_divergence_pe)
poisson = _scalarize(poisson_pe)
cosine_proximity = _scalarize(cosine_proximity_pe)


def rank_hinge(y_true, y_pred, margin: float = 1.0):
    """Pairwise ranking loss over consecutive (positive, negative) rows.
    Cross-batch structure means there is no per-example form."""
    y_pred = torch.as_tensor(y_pred).float().reshape(-1)
    pos = y_pred[0::2]
    neg = y_pred[1::2]
    return torch.mean(torch.clamp(margin - pos + neg, min=0.0))


LOSSES = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "binary_crossentropy": binary_crossentropy,
    "bce": binary_crossentropy,
    "bce_with_logits": binary_crossentropy_from_logits,
    "categorical_crossentropy": categorical_crossentropy,
    "cce": categorical_crossentropy,
    "cce_with_logits": categorical_crossentropy_from_logits,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "scce": sparse_categorical_crossentropy,
    "scce_with_logits": sparse_categorical_crossentropy_from_logits,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "rank_hinge": rank_hinge,
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
}


def get_loss(loss: Union[str, Callable]) -> Callable:
    if callable(loss):
        return loss
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}; available: "
                         f"{sorted(LOSSES)}")
    return LOSSES[loss]


def per_example_loss(loss: Union[str, Callable]) -> Optional[Callable]:
    """Per-example form of a loss, or None if the loss has cross-batch
    structure (rank_hinge) or is a custom callable without one."""
    return getattr(get_loss(loss), "per_example", None)
