"""Port of the matching ``analytics_zoo_tpu`` package."""
from .ranker import (RankerMixin, hit_rate,  # noqa: F401
                     mean_average_precision, ndcg)
from .zoo_model import ZooModel, load_model, register_model  # noqa: F401
