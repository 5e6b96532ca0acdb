"""WideAndDeep — port of ``analytics_zoo_tpu/models/recommendation/
wide_and_deep.py`` (``models/recommendation/WideAndDeep.scala:101`` and
the feature assembly of ``Utils.scala:104-132`` in the reference).

Input contract, as in the JAX package: every categorical column arrives
as an integer id per example. The wide part gathers rows of a
``(wide_total_dim, num_classes)`` table (one per column, at the column's
offset) and sums them — the reference's SparseDense over a multi-hot
vector, as a gather. Indicator columns become one-hot rows inside the
graph, embed columns get an ``Embedding`` table each, continuous columns
pass through.

Inputs (by model_type):
  wide_n_deep: [wide_ids (B, n_wide), ind_ids (B, n_ind),
                embed_ids (B, n_embed), continuous (B, n_cont)]
  wide:        [wide_ids]
  deep:        [ind_ids, embed_ids, continuous]
(empty groups are omitted; ``ColumnFeatureInfo.input_arrays`` builds them
from a dict of columns.)

Ids outside a table keep the JAX package's rules: the indicator one-hot
indexes an identity as ``jnp.eye(d)[x]`` does (an id in ``[-d, 0)``
wraps, then every id clamps into ``[0, d)``); the wide table and the deep
``Embedding``s gather with ``jnp.take``'s fill rule (NaN rows,
``take_rows``). The graph's functions are module-level callables, so a
fitted model pickles (``NNModel.save``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...pipeline.api.keras.engine import Input, Lambda, Model, unique_name
from ...pipeline.api.keras.layers import Dense, Embedding, Merge, Select
from ...pipeline.api.keras.layers.embeddings import take_rows
from ..common.zoo_model import register_model
from .neural_cf import Recommender


@dataclasses.dataclass
class ColumnFeatureInfo:
    """``ColumnFeatureInfo`` (``WideAndDeep.scala:55-80``) — names and dims
    of each feature group, plus the vectorized sample assembly (a copy of
    the JAX package's; plain numpy)."""

    wide_base_cols: Sequence[str] = ()
    wide_base_dims: Sequence[int] = ()
    wide_cross_cols: Sequence[str] = ()
    wide_cross_dims: Sequence[int] = ()
    indicator_cols: Sequence[str] = ()
    indicator_dims: Sequence[int] = ()
    embed_cols: Sequence[str] = ()
    embed_in_dims: Sequence[int] = ()
    embed_out_dims: Sequence[int] = ()
    continuous_cols: Sequence[str] = ()
    label: str = "label"

    @property
    def wide_dims(self) -> List[int]:
        return list(self.wide_base_dims) + list(self.wide_cross_dims)

    def input_arrays(self, table: Dict[str, np.ndarray], model_type: str
                     ) -> List[np.ndarray]:
        """Vectorized ``row2Sample`` (``Utils.scala:104-132``): build the
        model's input arrays from a dict of per-column numpy arrays."""
        outs: List[np.ndarray] = []
        wide_cols = list(self.wide_base_cols) + list(self.wide_cross_cols)
        if model_type in ("wide", "wide_n_deep") and wide_cols:
            outs.append(np.stack([np.asarray(table[c], np.int32)
                                  for c in wide_cols], axis=1))
        if model_type in ("deep", "wide_n_deep"):
            if self.indicator_cols:
                outs.append(np.stack([np.asarray(table[c], np.int32)
                                      for c in self.indicator_cols], axis=1))
            if self.embed_cols:
                outs.append(np.stack([np.asarray(table[c], np.int32)
                                      for c in self.embed_cols], axis=1))
            if self.continuous_cols:
                outs.append(np.stack([np.asarray(table[c], np.float32)
                                      for c in self.continuous_cols], axis=1))
        return outs


class _WideLinear(Embedding):
    """Wide part: per-column offset + gather from ``(wide_total,
    num_classes)`` weights, summed — the SparseDense linear over the
    concatenated multi-hot vector (``WideAndDeep.scala:118``), executed as
    a gather, plus an f32 ``bias``."""

    def __init__(self, wide_dims: Sequence[int], num_classes: int, **kwargs):
        super().__init__(int(sum(wide_dims)), num_classes, init="zero",
                         **kwargs)
        offsets = np.concatenate([[0], np.cumsum(wide_dims)[:-1]])
        self.register_buffer("offsets", torch.as_tensor(
            offsets.astype(np.int64)), persistent=False)

    def build(self, input_shape, *, generator):
        super().build(input_shape, generator=generator)
        self.add_weight("bias", torch.zeros(self.output_dim,
                                            dtype=torch.float32))

    def compute_output_shape(self, input_shape):
        return (input_shape[0], self.output_dim)

    def call(self, x, *, training=False, generator=None):
        rows = take_rows(self.embeddings, x.long() + self.offsets)  # (B, n, C)
        return torch.sum(rows, dim=1) + self.bias


class _IndicatorOneHot:
    """The indicator columns' one-hot rows, concatenated: ``jnp.eye(d)[x]``
    for each column (an id in ``[-d, 0)`` wraps, then ids clamp into
    ``[0, d)``), as an f32 comparison against an ``arange`` on the ids'
    device."""

    def __init__(self, dims: Sequence[int]):
        self.dims = [int(d) for d in dims]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        cols = []
        for i, d in enumerate(self.dims):
            ids = x[:, i].long()
            ids = torch.where(ids < 0, ids + d, ids).clamp(0, d - 1)
            cols.append((ids.unsqueeze(-1) == torch.arange(
                d, device=x.device)).to(torch.float32))
        return torch.cat(cols, dim=-1)


def _softmax(z: torch.Tensor) -> torch.Tensor:
    return torch.softmax(z, dim=-1)


@register_model
class WideAndDeep(Recommender):
    """``WideAndDeep(modelType, numClasses, columnInfo, hiddenLayers)``;
    ``device`` is where the weights live (``cuda`` unless given)."""

    def __init__(self, model_type: str = "wide_n_deep", num_classes: int = 2,
                 column_info: Optional[ColumnFeatureInfo] = None,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 name: Optional[str] = None, device=None, **column_kwargs):
        if model_type not in ("wide", "deep", "wide_n_deep"):
            raise ValueError(f"model_type must be wide|deep|wide_n_deep, "
                             f"got {model_type!r}")
        self.model_type = model_type
        self.num_classes = int(num_classes)
        self.column_info = column_info or ColumnFeatureInfo(**column_kwargs)
        self.hidden_layers = tuple(int(h) for h in hidden_layers)
        ci = self.column_info
        if model_type != "deep" and not ci.wide_dims:
            raise ValueError("wide model needs wide_base/cross dims")
        if model_type != "wide" and not (ci.indicator_cols or ci.embed_cols
                                         or ci.continuous_cols):
            raise ValueError("deep model needs indicator/embed/continuous cols")
        super().__init__(name=name, device=device)

    # ---- graph ------------------------------------------------------------
    def _deep_tower(self, inputs: List, ci: ColumnFeatureInfo):
        parts = []
        if ci.indicator_cols:
            ind = inputs.pop(0)
            parts.append(Lambda(_IndicatorOneHot(ci.indicator_dims),
                                name=unique_name("indicator_"))(ind))
        if ci.embed_cols:
            emb = inputs.pop(0)
            for i, (din, dout) in enumerate(zip(ci.embed_in_dims,
                                                ci.embed_out_dims)):
                col = Select(1, i)(emb)
                parts.append(Embedding(int(din), int(dout), init="normal")(col))
        if ci.continuous_cols:
            parts.append(inputs.pop(0))
        h = (Merge(mode="concat", concat_axis=-1)(parts)
             if len(parts) > 1 else parts[0])
        for units in self.hidden_layers:
            h = Dense(units, activation="relu")(h)
        return Dense(self.num_classes)(h)

    def build_model(self) -> Model:
        ci = self.column_info
        inputs = []
        wide_var = None
        if self.model_type in ("wide", "wide_n_deep"):
            wide_in = Input(shape=(len(ci.wide_dims),))
            inputs.append(wide_in)
            wide_var = _WideLinear(ci.wide_dims, self.num_classes)(wide_in)
        deep_inputs = []
        if self.model_type in ("deep", "wide_n_deep"):
            if ci.indicator_cols:
                deep_inputs.append(Input(shape=(len(ci.indicator_cols),)))
            if ci.embed_cols:
                deep_inputs.append(Input(shape=(len(ci.embed_cols),)))
            if ci.continuous_cols:
                deep_inputs.append(Input(shape=(len(ci.continuous_cols),)))
            inputs.extend(deep_inputs)

        softmax = Lambda(_softmax, name=unique_name("softmax_"))
        if self.model_type == "wide":
            out = softmax(wide_var)
        elif self.model_type == "deep":
            out = softmax(self._deep_tower(list(deep_inputs), ci))
        else:
            deep_var = self._deep_tower(list(deep_inputs), ci)
            out = softmax(Merge(mode="sum")([wide_var, deep_var]))
        return Model(inputs if len(inputs) > 1 else inputs[0], out,
                     device=self.device)

    def get_config(self) -> Dict[str, Any]:
        ci = self.column_info
        return {"model_type": self.model_type,
                "num_classes": self.num_classes,
                "hidden_layers": list(self.hidden_layers),
                "wide_base_cols": list(ci.wide_base_cols),
                "wide_base_dims": list(ci.wide_base_dims),
                "wide_cross_cols": list(ci.wide_cross_cols),
                "wide_cross_dims": list(ci.wide_cross_dims),
                "indicator_cols": list(ci.indicator_cols),
                "indicator_dims": list(ci.indicator_dims),
                "embed_cols": list(ci.embed_cols),
                "embed_in_dims": list(ci.embed_in_dims),
                "embed_out_dims": list(ci.embed_out_dims),
                "continuous_cols": list(ci.continuous_cols),
                "label": ci.label}
