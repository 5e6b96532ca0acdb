"""SessionRecommender — port of ``analytics_zoo_tpu/models/recommendation/
session_recommender.py`` (``models/recommendation/SessionRecommender.
scala:45`` of the reference).

Session item ids ``(B, session_length)`` → ``Embedding`` → stacked
``GRU``s (the last returns its final state) → ``Dense(item_count)``; with
``include_history``, the purchase history's ids → ``Embedding`` → a sum
over time (a ``Lambda``) → a ReLU MLP → ``Dense(item_count)``, the two
logits merged by sum; a softmax over ``item_count`` classes. The graph's
nodes take the JAX model's positional names.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...pipeline.api.keras.engine import Input, Lambda, Model, unique_name
from ...pipeline.api.keras.layers import (GRU, Activation, Dense, Embedding,
                                          Merge)
from ..common.zoo_model import register_model
from .neural_cf import Recommender


def history_sum(e: torch.Tensor) -> torch.Tensor:
    """The history's embedded items summed over time (a module-level
    function, so the model pickles)."""
    return torch.sum(e, dim=1)


@register_model
class SessionRecommender(Recommender):
    """``SessionRecommender(itemCount, itemEmbed, rnnHiddenLayers,
    sessionLength, includeHistory, mlpHiddenLayers, historyLength)``;
    ``device`` is where the weights live (``cuda`` unless given)."""

    def __init__(self, item_count: int, item_embed: int = 100,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 10, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 0, name: Optional[str] = None,
                 device=None):
        if include_history and history_length <= 0:
            raise ValueError("include_history requires history_length > 0")
        self.item_count = int(item_count)
        self.item_embed = int(item_embed)
        self.rnn_hidden_layers = tuple(int(h) for h in rnn_hidden_layers)
        self.session_length = int(session_length)
        self.include_history = bool(include_history)
        self.mlp_hidden_layers = tuple(int(h) for h in mlp_hidden_layers)
        self.history_length = int(history_length)
        super().__init__(name=name, device=device)

    def build_model(self) -> Model:
        inp_rnn = Input(shape=(self.session_length,))
        h = Embedding(self.item_count + 1, self.item_embed,
                      init="normal")(inp_rnn)
        for units in self.rnn_hidden_layers[:-1]:
            h = GRU(units, return_sequences=True)(h)
        h = GRU(self.rnn_hidden_layers[-1], return_sequences=False)(h)
        rnn_logits = Dense(self.item_count)(h)

        if not self.include_history:
            out = Activation("softmax")(rnn_logits)
            return Model(inp_rnn, out, device=self.device)

        inp_mlp = Input(shape=(self.history_length,))
        his = Embedding(self.item_count + 1, self.item_embed)(inp_mlp)
        m = Lambda(history_sum, name=unique_name("histsum_"))(his)
        for units in self.mlp_hidden_layers:
            m = Dense(units, activation="relu")(m)
        mlp_logits = Dense(self.item_count)(m)
        merged = Merge(mode="sum")([rnn_logits, mlp_logits])
        out = Activation("softmax")(merged)
        return Model([inp_rnn, inp_mlp], out, device=self.device)

    def recommend_for_session(self, sessions, max_items: int = 5,
                              zero_based_label: bool = True,
                              batch_size: int = 1024
                              ) -> List[List[Tuple[int, float]]]:
        """``recommendForSession``: the top ``max_items`` (item,
        probability) pairs of each session, by a numpy ``argsort`` of the
        host probabilities."""
        probs = self.predict(sessions, batch_size=batch_size)
        top = np.argsort(-probs, axis=1)[:, :max_items]
        base = 0 if zero_based_label else 1
        return [[(int(i) + base, float(p[i])) for i in row]
                for row, p in zip(top, probs)]

    def get_config(self) -> Dict[str, Any]:
        return {"item_count": self.item_count, "item_embed": self.item_embed,
                "rnn_hidden_layers": list(self.rnn_hidden_layers),
                "session_length": self.session_length,
                "include_history": self.include_history,
                "mlp_hidden_layers": list(self.mlp_hidden_layers),
                "history_length": self.history_length}
