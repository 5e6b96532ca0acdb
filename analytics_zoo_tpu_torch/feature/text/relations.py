"""Relations — a copy of ``analytics_zoo_tpu/feature/text/relations.py``
(plain Python and numpy). The QA-ranking data path, parity with
``feature/common/Relations.scala:26-160`` and the relation-pair/list TextSet
factories (``feature/text/TextSet.scala:399-533``).

A ``Relation(id1, id2, label)`` links a query to a candidate document with a
relevance label. Training consumes *pairs* (each positive of a query crossed
with each of its negatives; rows interleaved pos/neg for the ``rank_hinge``
loss), evaluation consumes *lists* (every candidate of a query as one group
for NDCG/MAP/HitRate via ``RankerMixin``). The reference materializes these
through Spark joins on URI-keyed RDDs; here corpora are id→indices maps and
the joins are dict lookups — arrays come out dense and static-shaped for the
training step.
"""

from __future__ import annotations

import collections
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import numpy as np

from .text_set import TextSet

__all__ = ["Relation", "RelationPair", "read_relations",
           "generate_relation_pairs", "relation_pairs_to_arrays",
           "relation_lists_to_groups"]


class Relation(NamedTuple):
    id1: str
    id2: str
    label: int


class RelationPair(NamedTuple):
    id1: str
    id2_positive: str
    id2_negative: str


def read_relations(path: str) -> List[Relation]:
    """``Relations.read`` (``Relations.scala:44-67``): csv/txt lines of
    ``id1,id2,label`` (no header)."""
    out: List[Relation] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) < 3:
                raise ValueError(f"{path}: bad relation line {line!r}")
            out.append(Relation(parts[0], parts[1], int(parts[2])))
    return out


def generate_relation_pairs(
        relations: Sequence[Relation]) -> List[RelationPair]:
    """``Relations.generateRelationPairs`` (``Relations.scala:88+``): for
    each query, every positive (label > 0) crosses every negative
    (label == 0). Deterministic order (query, positive, negative)."""
    by_q: Dict[str, Tuple[List[str], List[str]]] = collections.OrderedDict()
    for r in relations:
        pos, neg = by_q.setdefault(r.id1, ([], []))
        (pos if r.label > 0 else neg).append(r.id2)
    pairs: List[RelationPair] = []
    for q, (pos, neg) in by_q.items():
        for p in pos:
            for n in neg:
                pairs.append(RelationPair(q, p, n))
    return pairs


def _corpus_map(corpus: Union[TextSet, Dict[str, np.ndarray]]
                ) -> Dict[str, np.ndarray]:
    if isinstance(corpus, TextSet):
        return corpus.indices_by_id()
    return {k: np.asarray(v, np.int32) for k, v in corpus.items()}


def _lookup(m: Dict[str, np.ndarray], key: str, side: str) -> np.ndarray:
    try:
        return m[key]
    except KeyError:
        raise KeyError(f"relation id {key!r} missing from {side}") from None


def relation_pairs_to_arrays(
        relations: Sequence[Relation],
        corpus1: Union[TextSet, Dict[str, np.ndarray]],
        corpus2: Union[TextSet, Dict[str, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """``TextSet.fromRelationPairs`` (``TextSet.scala:399-470``): join pairs
    with both corpora and emit ``(x, y)`` where ``x`` is
    ``(2 * n_pairs, len1 + len2)`` int32 — row ``2i`` = [query ++ positive],
    row ``2i+1`` = [query ++ negative], exactly the consecutive-pair layout
    ``rank_hinge`` consumes (train UNSHUFFLED, keep batch sizes even). ``y``
    is the matching 1/0 labels (unused by rank_hinge; usable for AUC)."""
    c1, c2 = _corpus_map(corpus1), _corpus_map(corpus2)
    rows: List[np.ndarray] = []
    for pair in generate_relation_pairs(relations):
        q = _lookup(c1, pair.id1, "corpus1")
        rows.append(np.concatenate(
            [q, _lookup(c2, pair.id2_positive, "corpus2")]))
        rows.append(np.concatenate(
            [q, _lookup(c2, pair.id2_negative, "corpus2")]))
    if not rows:
        raise ValueError("no relation pairs (no query has both a positive "
                         "and a negative)")
    x = np.stack(rows).astype(np.int32)
    y = np.tile(np.asarray([1, 0], np.float32), len(rows) // 2)
    return x, y


def relation_lists_to_groups(
        relations: Sequence[Relation],
        corpus1: Union[TextSet, Dict[str, np.ndarray]],
        corpus2: Union[TextSet, Dict[str, np.ndarray]],
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``TextSet.fromRelationLists`` (``TextSet.scala:503-533``): one
    ``(x, y)`` group per query over ALL its candidates — the input
    ``RankerMixin.evaluate_ndcg/evaluate_map/evaluate_hit_rate`` take."""
    c1, c2 = _corpus_map(corpus1), _corpus_map(corpus2)
    by_q: Dict[str, List[Relation]] = collections.OrderedDict()
    for r in relations:
        by_q.setdefault(r.id1, []).append(r)
    groups: List[Tuple[np.ndarray, np.ndarray]] = []
    for q, rels in by_q.items():
        qv = _lookup(c1, q, "corpus1")
        x = np.stack([np.concatenate([qv, _lookup(c2, r.id2, "corpus2")])
                      for r in rels]).astype(np.int32)
        y = np.asarray([r.label for r in rels], np.float32)
        groups.append((x, y))
    return groups
