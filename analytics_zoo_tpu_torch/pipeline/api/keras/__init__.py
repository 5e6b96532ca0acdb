"""Port of ``analytics_zoo_tpu/pipeline/api/keras``."""
from .engine import (Layer, Input, Variable, Lambda, InputLayer,  # noqa: F401
                     Sequential, Model, KerasNet, set_policy)
from . import training  # noqa: F401  (attaches compile/fit/evaluate/predict)
from . import objectives, metrics, optimizers  # noqa: F401
