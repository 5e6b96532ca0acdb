"""NeuralCF — port of ``analytics_zoo_tpu/models/recommendation/
neural_cf.py`` (``models/recommendation/NeuralCF.scala:45-104`` of the
reference).

Graph, as in the JAX package: input ``(B, 2)`` of ``[user_id, item_id]``
(1-based ids; the tables have ``count + 1`` rows) → an MLP tower (user
and item embeddings concatenated, then a ReLU Dense stack) and optionally
a matrix-factorization tower (its own embeddings, multiplied
elementwise), concatenated → a softmax over ``class_num`` classes. The
layers get the JAX package's positional names, so ``load_jax_params``
moves a JAX NeuralCF's weights across name for name. The model keeps
plain ``Embedding`` layers, as the JAX model does; the same graph built
with ``ShardedEmbedding`` runs the dedup'd engine.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from ...pipeline.api.keras.engine import Input, Model
from ...pipeline.api.keras.layers import Dense, Embedding, Merge, Select
from ..common.ranker import RankerMixin
from ..common.zoo_model import ZooModel, register_model


class Recommender(RankerMixin, ZooModel):
    """Base recommender — ``models/recommendation/Recommender.scala``:
    prediction over (user, item) pairs."""

    def predict_user_item_pair(self, user_item_pairs: np.ndarray,
                               batch_size: int = 1024) -> np.ndarray:
        """Probability per (user, item) row — ``predictUserItemPair``."""
        return self.predict(np.asarray(user_item_pairs), batch_size=batch_size)

    @staticmethod
    def _top_ids(ids: np.ndarray, probs: np.ndarray,
                 max_items: int) -> np.ndarray:
        """Recommender.scala:55,92-96 sorts by (predicted class desc,
        probability of that class desc)."""
        if probs.ndim > 1:
            cls = np.argmax(probs, axis=1)
            p_cls = probs[np.arange(len(cls)), cls]
            top = np.lexsort((-p_cls, -cls))[:max_items]
        else:
            top = np.argsort(-probs)[:max_items]
        return ids[top]

    def recommend_for_user(self, user_id: int, candidate_items: np.ndarray,
                           max_items: int = 10,
                           batch_size: int = 1024) -> np.ndarray:
        """Top-``max_items`` item ids for one user — ``recommendForUser``."""
        items = np.asarray(candidate_items).reshape(-1)
        pairs = np.stack([np.full_like(items, user_id), items], axis=1)
        return self._top_ids(items, self.predict(pairs, batch_size=batch_size),
                             max_items)

    def recommend_for_item(self, item_id: int, candidate_users: np.ndarray,
                           max_items: int = 10,
                           batch_size: int = 1024) -> np.ndarray:
        """Top-``max_items`` user ids for one item — ``recommendForItem``."""
        users = np.asarray(candidate_users).reshape(-1)
        pairs = np.stack([users, np.full_like(users, item_id)], axis=1)
        return self._top_ids(users, self.predict(pairs, batch_size=batch_size),
                             max_items)


@register_model
class NeuralCF(Recommender):
    """``NeuralCF(user_count, item_count, class_num, user_embed, item_embed,
    hidden_layers, include_mf, mf_embed)``; ``device`` is where the weights
    live (``cuda`` unless given)."""

    def __init__(self, user_count: int, item_count: int, class_num: int,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 name: Optional[str] = None, device=None):
        self.user_count = int(user_count)
        self.item_count = int(item_count)
        self.class_num = int(class_num)
        self.user_embed = int(user_embed)
        self.item_embed = int(item_embed)
        self.hidden_layers = tuple(int(h) for h in hidden_layers)
        self.include_mf = bool(include_mf)
        self.mf_embed = int(mf_embed)
        super().__init__(name=name, device=device)

    def build_model(self) -> Model:
        inp = Input(shape=(2,), name=self.name + "_input")
        user = Select(1, 0)(inp)   # (B,) user ids
        item = Select(1, 1)(inp)   # (B,) item ids
        # +1: ids are 1-based (NeuralCF.scala:67)
        mlp_user = Embedding(self.user_count + 1, self.user_embed,
                             init="normal")(user)
        mlp_item = Embedding(self.item_count + 1, self.item_embed,
                             init="normal")(item)
        h = Merge(mode="concat", concat_axis=-1)([mlp_user, mlp_item])
        for units in self.hidden_layers:
            h = Dense(units, activation="relu")(h)
        if self.include_mf:
            if self.mf_embed <= 0:
                raise ValueError("mf_embed must be positive when include_mf")
            mf_user = Embedding(self.user_count + 1, self.mf_embed,
                                init="normal")(user)
            mf_item = Embedding(self.item_count + 1, self.mf_embed,
                                init="normal")(item)
            mf = Merge(mode="mul")([mf_user, mf_item])
            h = Merge(mode="concat", concat_axis=-1)([h, mf])
        out = Dense(self.class_num, activation="softmax")(h)
        return Model(inp, out, device=self.device)

    def get_config(self) -> Dict[str, Any]:
        return {"user_count": self.user_count, "item_count": self.item_count,
                "class_num": self.class_num, "user_embed": self.user_embed,
                "item_embed": self.item_embed,
                "hidden_layers": list(self.hidden_layers),
                "include_mf": self.include_mf, "mf_embed": self.mf_embed}
