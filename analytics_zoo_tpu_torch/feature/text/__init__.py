"""Port of ``analytics_zoo_tpu/feature/text``: the text pipeline
(``feature/text`` of the reference, L2)."""

from .relations import (Relation, RelationPair, generate_relation_pairs,
                        read_relations, relation_lists_to_groups,
                        relation_pairs_to_arrays)
from .text_set import TextFeature, TextSet

__all__ = ["TextFeature", "TextSet", "Relation", "RelationPair",
           "read_relations", "generate_relation_pairs",
           "relation_pairs_to_arrays", "relation_lists_to_groups"]
