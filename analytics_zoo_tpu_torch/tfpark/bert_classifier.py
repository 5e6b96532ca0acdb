"""BERTClassifier — port of ``analytics_zoo_tpu/tfpark/bert_classifier.py``
(``_BertClassifierNet``, ``BERTClassifier``, ``make_bert_inputs``, the
torch/HuggingFace encoder import ``bert_params_from_torch`` and
``install_pretrained_bert``) plus :func:`load_jax_params`, which moves a
JAX param tree across name for name. ``BERTClassifier`` trains through
the ``KerasNet`` facade: ``compile``/``fit``/``evaluate``/``predict``."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
from torch import nn

from ..models.common.zoo_model import ZooModel, register_model
from ..pipeline.api.keras.engine import Layer, dispatch_layer, load_param_tree
from ..pipeline.api.keras.layers import BERT, Dense, Dropout


class _BertClassifierNet(Layer):
    """BERT encoder → pooled → dropout → softmax head, as one Layer."""

    def __init__(self, spec: "BERTClassifier", **kwargs):
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
        self.cls = Dense(spec.num_classes, activation="softmax",
                         name=f"{self.name}_cls")

    @property
    def input_shape(self):
        return [(None, self.seq_len)] * 4

    def build(self, input_shape=None, *, generator):
        self.bert.build(input_shape, generator=generator)
        self.cls.build((None, self.hidden_size), generator=generator)

    def call(self, x, *, training=False, generator=None):
        from ..pipeline.api.keras.layers.self_attention import \
            _split_generator
        g1, g2 = _split_generator(generator, 2)
        _, pooled = self.bert(x, training=training, generator=g1)
        pooled = self.drop(pooled, training=training, generator=g2)
        # the head goes through dispatch_layer so loss resolution can fuse
        # it and the inference runtime can intercept it like any
        # container-dispatched Dense
        return dispatch_layer(self.cls, pooled, training=training)

    def fused_head(self):
        """Fused LM-head loss resolution (``keras/fused_loss.py``)."""
        return self.cls, ("cls",)


@register_model
class BERTClassifier(ZooModel):
    """``BERTClassifier(num_classes, bert_config..., device=)`` — input
    ``[token_ids, token_type_ids, position_ids, attention_mask]``, each
    ``(B, seq_len)``; build them with :func:`make_bert_inputs`."""

    def __init__(self, num_classes: int, vocab: int = 40990,
                 hidden_size: int = 768, n_block: int = 12, n_head: int = 12,
                 seq_len: int = 512, intermediate_size: int = 3072,
                 hidden_drop: float = 0.1, attn_drop: float = 0.1,
                 name: Optional[str] = None, device=None):
        self.num_classes = int(num_classes)
        self.vocab = int(vocab)
        self.hidden_size = int(hidden_size)
        self.n_block = int(n_block)
        self.n_head = int(n_head)
        self.seq_len = int(seq_len)
        self.intermediate_size = int(intermediate_size)
        self.hidden_drop = float(hidden_drop)
        self.attn_drop = float(attn_drop)
        super().__init__(name=name, device=device)

    def build_model(self) -> _BertClassifierNet:
        return _BertClassifierNet(self, name=self.name + "_net")

    def get_config(self) -> Dict[str, Any]:
        return {"num_classes": self.num_classes, "vocab": self.vocab,
                "hidden_size": self.hidden_size, "n_block": self.n_block,
                "n_head": self.n_head, "seq_len": self.seq_len,
                "intermediate_size": self.intermediate_size,
                "hidden_drop": self.hidden_drop,
                "attn_drop": self.attn_drop}

    def make_inputs(self, token_ids, token_type_ids=None,
                    attention_mask=None):
        """[ids, token_type, position, mask] from just token ids."""
        return make_bert_inputs(token_ids, token_type_ids, attention_mask)

    def load_pretrained(self, state_dict: Mapping[str, Any]
                        ) -> "BERTClassifier":
        """Install encoder weights from a HuggingFace/torch BERT
        ``state_dict``; the classifier head keeps its fresh init (the
        fine-tuning setup)."""
        return install_pretrained_bert(self, state_dict)


def make_bert_inputs(token_ids: np.ndarray,
                     token_type_ids: Optional[np.ndarray] = None,
                     attention_mask: Optional[np.ndarray] = None):
    """[ids, token_type, position, mask] from just token ids — the input
    assembly every BERT estimator shares (numpy, int32 / float32)."""
    ids = np.asarray(token_ids, np.int32)
    b, t = ids.shape
    tt = (np.asarray(token_type_ids, np.int32)
          if token_type_ids is not None else np.zeros((b, t), np.int32))
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    mask = (np.asarray(attention_mask, np.float32)
            if attention_mask is not None else np.ones((b, t), np.float32))
    return [ids, tt, pos, mask]


def install_pretrained_bert(model: ZooModel, state_dict: Mapping[str, Any]):
    """Install torch BERT encoder weights into a ZooModel whose network
    has a ``bert`` encoder; the task head keeps its fresh init. Every
    encoder key and shape must match."""
    if not model.built:
        model.init_weights()
    load_param_tree(model.model.bert,
                    bert_params_from_torch(state_dict, model.n_block))
    return model


def bert_params_from_torch(state_dict: Mapping[str, Any],
                           n_block: int) -> Dict[str, Any]:
    """Map a transformers ``BertModel.state_dict()`` onto the ``BERT``
    encoder's param tree (the JAX package's keys). torch ``Linear.weight``
    is (out, in) — transposed into the (in, out) ``W`` layout; the q/k/v
    projections concatenate into the fused ``qkv`` kernel."""

    def t(key):
        v = state_dict[key]
        return np.asarray(v.detach().cpu().numpy()
                          if hasattr(v, "detach") else v)

    def dense(prefix):
        return {"W": t(f"{prefix}.weight").T, "b": t(f"{prefix}.bias")}

    def ln(prefix):
        return {"gamma": t(f"{prefix}.weight"), "beta": t(f"{prefix}.bias")}

    p: Dict[str, Any] = {
        "word": t("embeddings.word_embeddings.weight"),
        "position": t("embeddings.position_embeddings.weight"),
        "token_type": t("embeddings.token_type_embeddings.weight"),
        "emb_ln": ln("embeddings.LayerNorm"),
        "pooler": dense("pooler.dense"),
    }
    for i in range(n_block):
        b = f"encoder.layer.{i}"
        qkv_w = np.concatenate([t(f"{b}.attention.self.{m}.weight").T
                                for m in ("query", "key", "value")], axis=1)
        qkv_b = np.concatenate([t(f"{b}.attention.self.{m}.bias")
                                for m in ("query", "key", "value")])
        p[f"block{i}"] = {
            "attn": {"qkv": {"W": qkv_w, "b": qkv_b},
                     "proj": dense(f"{b}.attention.output.dense")},
            "ln1": ln(f"{b}.attention.output.LayerNorm"),
            "fc": dense(f"{b}.intermediate.dense"),
            "out": dense(f"{b}.output.dense"),
            "ln2": ln(f"{b}.output.LayerNorm"),
        }
    return p


def load_jax_params(model: nn.Module, tree: Mapping[str, Any]) -> None:
    """Fill ``model`` from a JAX ``params`` tree (nested dicts of numpy
    arrays) name for name: ``bert/word``, ``bert/block0/attn/qkv/W``,
    ``cls/W`` ... Every shape is checked; a missing or an extra key
    raises. A ``ZooModel`` is filled through its inner network, whose
    parameter paths are the JAX tree's."""
    if isinstance(model, ZooModel):
        model.load_jax_params(dict(tree))
    else:
        load_param_tree(model, dict(tree))
