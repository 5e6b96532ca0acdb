"""BERTNER + BERTSQuAD — port of ``analytics_zoo_tpu/tfpark/bert_ner.py``
(the reference's prebuilt BERT estimators,
``pyzoo/zoo/tfpark/text/estimator/bert_ner.py``: sequence output →
dense(num_entities) with mask-weighted softmax CE; ``bert_squad.py``:
sequence output → dense(2) split into start/end logits).

One Layer wraps the port's BERT encoder and a per-token head, as
``tfpark/bert_classifier.py`` does for the pooled head, and trains with
compile/fit; on the card the encoder's attention runs K2, K3a and K3b
(``zoo.pallas.attention``, with ``attn_drop`` 0). Padding handling is by
ignore-labels: token positions labeled ``< 0`` are excluded from the NER
loss (the masked-CE normalization of the reference's
``_bert_ner_model_fn``), so the loss needs no side channel to the
attention mask. The layers carry the JAX names (``<name>_bert``,
``<name>_drop``, ``<name>_head``; param tree ``{"bert", "head"}``), so
``load_jax_params`` and the ``.npz`` move weights both ways.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..models.common.zoo_model import ZooModel, register_model
from ..pipeline.api.keras.engine import Layer
from ..pipeline.api.keras.layers import BERT, Dense, Dropout
from ..pipeline.api.keras.layers.self_attention import _split_generator
from .bert_classifier import install_pretrained_bert, make_bert_inputs

__all__ = ["BERTNER", "BERTSQuAD", "masked_token_scce", "squad_span_loss"]


def masked_token_scce(y_true, y_pred):
    """Mean CE over tokens whose label ≥ 0 (mask-weighted loss of
    ``_bert_ner_model_fn``)."""
    labels = torch.as_tensor(y_true).to(torch.int64)
    mask = (labels >= 0).to(torch.float32)
    logp = torch.log_softmax(y_pred.to(torch.float32), dim=-1)
    picked = torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.sum(-picked * mask) / torch.clamp(torch.sum(mask),
                                                   min=1e-12)


def squad_span_loss(y_true, y_pred):
    """y_true (B, 2) start/end positions; y_pred (B, T, 2) logits.
    Mean of start CE and end CE (``bert_squad.py`` semantics)."""
    spans = torch.as_tensor(y_true).to(torch.int64)
    logits = y_pred.to(torch.float32)

    def ce(lg, pos):
        logp = torch.log_softmax(lg, dim=-1)
        return -torch.gather(logp, -1, pos[:, None])[:, 0]

    return torch.mean(0.5 * (ce(logits[..., 0], spans[:, 0])
                             + ce(logits[..., 1], spans[:, 1])))


class _BertTokenHeadNet(Layer):
    """BERT encoder → dropout → per-token dense head (shared by NER and
    SQuAD)."""

    def __init__(self, spec: "_BertTokenEstimator", head_dim: int,
                 **kwargs):
        super().__init__(**kwargs)
        self.seq_len = spec.seq_len
        self.hidden_size = spec.hidden_size
        self.bert = BERT(vocab=spec.vocab, hidden_size=spec.hidden_size,
                         n_block=spec.n_block, n_head=spec.n_head,
                         seq_len=spec.seq_len,
                         intermediate_size=spec.intermediate_size,
                         hidden_drop=spec.hidden_drop,
                         attn_drop=spec.attn_drop, name=f"{self.name}_bert")
        self.drop = Dropout(spec.hidden_drop, name=f"{self.name}_drop")
        self.head = Dense(head_dim, name=f"{self.name}_head")

    @property
    def input_shape(self):
        return [(None, self.seq_len)] * 4

    def build(self, input_shape=None, *, generator):
        self.bert.build(input_shape, generator=generator)
        self.head.build((None, self.seq_len, self.hidden_size),
                        generator=generator)

    def call(self, x, *, training=False, generator=None):
        g1, g2 = _split_generator(generator, 2)
        seq, _ = self.bert(x, training=training, generator=g1)
        seq = self.drop(seq, training=training, generator=g2)
        return self.head(seq)


class _BertTokenEstimator(ZooModel):
    """Shared NER/SQuAD plumbing (config, build, weight import)."""

    _HEAD_DIM: int = 0

    def __init__(self, vocab: int = 40990, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12, seq_len: int = 512,
                 intermediate_size: int = 3072, hidden_drop: float = 0.1,
                 attn_drop: float = 0.1, name: Optional[str] = None,
                 device=None):
        self.vocab = int(vocab)
        self.hidden_size = int(hidden_size)
        self.n_block = int(n_block)
        self.n_head = int(n_head)
        self.seq_len = int(seq_len)
        self.intermediate_size = int(intermediate_size)
        self.hidden_drop = float(hidden_drop)
        self.attn_drop = float(attn_drop)
        super().__init__(name=name, device=device)

    def build_model(self) -> _BertTokenHeadNet:
        return _BertTokenHeadNet(self, self._HEAD_DIM,
                                 name=self.name + "_net")

    def get_config(self) -> Dict[str, Any]:
        return {"vocab": self.vocab, "hidden_size": self.hidden_size,
                "n_block": self.n_block, "n_head": self.n_head,
                "seq_len": self.seq_len,
                "intermediate_size": self.intermediate_size,
                "hidden_drop": self.hidden_drop,
                "attn_drop": self.attn_drop}

    def make_inputs(self, token_ids, token_type_ids=None,
                    attention_mask=None):
        return make_bert_inputs(token_ids, token_type_ids, attention_mask)

    def load_pretrained(self, state_dict: Mapping[str, Any]):
        return install_pretrained_bert(self, state_dict)

    def compile(self, optimizer="adam", loss=None, metrics=None, **kwargs):
        loss = loss or self._default_loss()
        return super().compile(optimizer=optimizer, loss=loss,
                               metrics=metrics, **kwargs)


@register_model
class BERTNER(_BertTokenEstimator):
    """``BERTNER(num_entities, ...)`` — token labels < 0 are ignore
    positions (padding). ``predict_tags`` returns per-token argmax ids."""

    _HEAD_DIM = 0  # set per instance

    def __init__(self, num_entities: int, **kwargs):
        self.num_entities = int(num_entities)
        self._HEAD_DIM = self.num_entities
        super().__init__(**kwargs)

    def get_config(self):
        cfg = super().get_config()
        cfg["num_entities"] = self.num_entities
        return cfg

    def _default_loss(self):
        return masked_token_scce

    def predict_tags(self, inputs, batch_size: int = 32) -> np.ndarray:
        logits = np.asarray(self.predict(inputs, batch_size=batch_size))
        return np.argmax(logits, axis=-1)


@register_model
class BERTSQuAD(_BertTokenEstimator):
    """``BERTSQuAD(...)`` — span extraction: output (B, T, 2) start/end
    logits; targets (B, 2) positions."""

    _HEAD_DIM = 2

    def _default_loss(self):
        return squad_span_loss

    def predict_spans(self, inputs, batch_size: int = 32):
        """(start, end) argmax positions with end ≥ start enforced by a
        triangular joint-score sweep."""
        logits = np.asarray(self.predict(inputs, batch_size=batch_size))
        start_lp = logits[..., 0]
        end_lp = logits[..., 1]
        t = start_lp.shape[1]
        joint = start_lp[:, :, None] + end_lp[:, None, :]
        joint = np.where(np.triu(np.ones((t, t), bool))[None], joint,
                         -np.inf)
        flat = joint.reshape(joint.shape[0], -1).argmax(axis=1)
        return np.stack([flat // t, flat % t], axis=1)
