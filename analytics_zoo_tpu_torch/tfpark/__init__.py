"""Port of the matching ``analytics_zoo_tpu`` package: ``BERTClassifier``,
``BERTNER`` and ``BERTSQuAD``."""

from .bert_classifier import (BERTClassifier,  # noqa: F401
                              bert_params_from_torch)
from .bert_ner import (BERTNER, BERTSQuAD, masked_token_scce,  # noqa: F401
                       squad_span_loss)
