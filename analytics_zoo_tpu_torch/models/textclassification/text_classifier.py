"""TextClassifier — port of ``analytics_zoo_tpu/models/textclassification/
text_classifier.py`` (``models/textclassification/TextClassifier.scala:34``
of the reference).

Token ids ``(B, sequence_length)`` → an embedding (a frozen
``WordEmbedding`` of pretrained vectors, the GloVe path, whose table is
constant model state and rides the ``.npz`` as ``embedding_weights``; or
a trainable ``Embedding``) → the encoder (cnn: ``Convolution1D`` 5 wide
with ReLU, then ``GlobalMaxPooling1D``; lstm/gru: the last hidden state)
→ ``Dense(128, relu)`` → ``Dropout(0.2)`` → ``Dense(class_num,
softmax)``, with the JAX model's layer names.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ...pipeline.api.keras.engine import Sequential
from ...pipeline.api.keras.layers import (GRU, LSTM, Convolution1D, Dense,
                                          Dropout, Embedding,
                                          GlobalMaxPooling1D, WordEmbedding)
from ..common.zoo_model import ZooModel, register_model


@register_model
class TextClassifier(ZooModel):
    """``TextClassifier(classNum, tokenLength, sequenceLength, encoder,
    encoderOutputDim)``: give ``vocab_size`` (a trainable embedding) or
    ``embedding_weights`` (pretrained and frozen); ``device`` is where the
    weights live (``cuda`` unless given)."""

    def __init__(self, class_num: int, token_length: int = 200,
                 sequence_length: int = 500, encoder: str = "cnn",
                 encoder_output_dim: int = 256,
                 vocab_size: Optional[int] = None,
                 embedding_weights: Optional[np.ndarray] = None,
                 name: Optional[str] = None, device=None):
        if encoder not in ("cnn", "lstm", "gru"):
            raise ValueError(f"encoder must be cnn|lstm|gru, got {encoder!r}")
        if vocab_size is None and embedding_weights is None:
            raise ValueError("provide vocab_size or embedding_weights")
        self.class_num = int(class_num)
        self.token_length = int(token_length)
        self.sequence_length = int(sequence_length)
        self.encoder = encoder
        self.encoder_output_dim = int(encoder_output_dim)
        self.vocab_size = vocab_size
        self.embedding_weights = (np.asarray(embedding_weights, np.float32)
                                  if embedding_weights is not None else None)
        super().__init__(name=name, device=device)

    def build_model(self) -> Sequential:
        m = Sequential(device=self.device)
        if self.embedding_weights is not None:
            m.add(WordEmbedding(self.embedding_weights, trainable=False,
                                input_shape=(self.sequence_length,)))
        else:
            m.add(Embedding(self.vocab_size, self.token_length,
                            input_shape=(self.sequence_length,)))
        if self.encoder == "cnn":
            m.add(Convolution1D(self.encoder_output_dim, 5,
                                activation="relu"))
            m.add(GlobalMaxPooling1D())
        elif self.encoder == "lstm":
            m.add(LSTM(self.encoder_output_dim))
        else:
            m.add(GRU(self.encoder_output_dim))
        m.add(Dense(128, activation="relu"))
        m.add(Dropout(0.2))
        m.add(Dense(self.class_num, activation="softmax"))
        return m

    def get_config(self) -> Dict[str, Any]:
        cfg = {"class_num": self.class_num,
               "token_length": self.token_length,
               "sequence_length": self.sequence_length,
               "encoder": self.encoder,
               "encoder_output_dim": self.encoder_output_dim}
        if self.vocab_size is not None:
            cfg["vocab_size"] = self.vocab_size
        return cfg

    def extra_arrays(self):
        if self.embedding_weights is not None:
            return {"embedding_weights": self.embedding_weights}
        return {}
