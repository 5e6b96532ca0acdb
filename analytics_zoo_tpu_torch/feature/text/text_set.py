"""TextSet — a copy of ``analytics_zoo_tpu/feature/text/text_set.py``
(plain Python and numpy, so nothing changes in the port), resting on the
port's ``FeatureSet``/``BucketedFeatureSet``. Parity with
``feature/text/TextSet.scala`` (Local/Distributed text collections) and its
transformer chain:

* ``read`` (``TextSet.scala:290``): per-class-subdirectory corpus or
  in-memory (text, label) pairs; ``read_csv``/``read_parquet``
  (``TextSet.scala:345,372``) become ``from_csv``/``from_parquet``.
* ``tokenize`` (``TextSet.scala:97`` → ``Tokenizer.scala``) and
  ``normalize`` (``Normalizer.scala``): host-side string ops.
* ``word2idx`` (``TextSet.scala:147`` → ``WordIndexer.scala``): frequency
  vocabulary, 1-based indices (0 = padding / OOV), ``remove_topN`` and
  ``max_words_num`` semantics kept.
* ``shape_sequence`` (``SequenceShaper.scala``): fixed-length pad/truncate
  (a captured training step wants static shapes too).
* ``generate_sample`` (``TextSet.scala:177`` → ``TextFeatureToSample.scala``):
  dense int32 arrays ready for the ``FeatureSet``.

One process holds one host shard (the reference's DistributedTextSet role).
"""

from __future__ import annotations

import collections
import csv
import os
import re
import string
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..feature_set import BucketedFeatureSet, FeatureSet

__all__ = ["TextFeature", "TextSet"]

_PUNCT_RE = re.compile(f"[{re.escape(string.punctuation)}]")


class TextFeature:
    """One text record (``TextFeature.scala``): raw text, optional label,
    optional ``uri`` identifier (the reference keys relation corpora by
    URI), accumulated pipeline fields (tokens, indices)."""

    def __init__(self, text: str, label: Optional[int] = None,
                 uri: Optional[str] = None):
        self.text = text
        self.label = label
        self.uri = uri
        self.tokens: Optional[List[str]] = None
        self.indices: Optional[np.ndarray] = None

    def __repr__(self):
        return f"TextFeature({self.text[:30]!r}, label={self.label})"


class TextSet:
    def __init__(self, features: List[TextFeature],
                 word_index: Optional[Dict[str, int]] = None,
                 label_map: Optional[Dict[str, int]] = None):
        self.features = features
        self.word_index = word_index
        self.label_map = label_map

    # ---- factories (TextSet.scala:290,345) --------------------------------
    @staticmethod
    def from_pairs(pairs: Sequence[Tuple[str, Optional[int]]]) -> "TextSet":
        return TextSet([TextFeature(t, l) for t, l in pairs])

    @staticmethod
    def from_texts(texts: Sequence[str],
                   labels: Optional[Sequence[int]] = None) -> "TextSet":
        labels = labels if labels is not None else [None] * len(texts)
        return TextSet([TextFeature(t, l) for t, l in zip(texts, labels)])

    @staticmethod
    def from_corpus(mapping: Dict[str, str]) -> "TextSet":
        """An id→text corpus (the reference's URI-keyed relation corpora,
        ``TextSet.scala:399-470``); deterministic id order."""
        return TextSet([TextFeature(t, uri=i)
                        for i, t in sorted(mapping.items())])

    def indices_by_id(self) -> Dict[str, np.ndarray]:
        """URI → fixed-length index vector; requires the tokenize →
        word2idx → shape_sequence chain to have run."""
        out: Dict[str, np.ndarray] = {}
        for f in self.features:
            if f.uri is None:
                raise RuntimeError("corpus features need uris; build via "
                                   "TextSet.from_corpus")
            if f.indices is None:
                raise RuntimeError("run tokenize/word2idx/shape_sequence "
                                   "before indices_by_id()")
            out[f.uri] = f.indices
        return out

    @staticmethod
    def read(path: str) -> "TextSet":
        """Per-class-subdirectory corpus of ``.txt`` files
        (``TextSet.scala:290`` folder convention); labels by sorted class
        name."""
        classes = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d)))
        if not classes:
            raise ValueError(f"{path}: need per-class subdirectories")
        label_map = {c: i for i, c in enumerate(classes)}
        feats = []
        for c in classes:
            d = os.path.join(path, c)
            for f in sorted(os.listdir(d)):
                if f.endswith(".txt"):
                    with open(os.path.join(d, f), encoding="utf-8") as fh:
                        feats.append(TextFeature(fh.read(), label_map[c]))
        return TextSet(feats, label_map=label_map)

    @staticmethod
    def from_csv(path: str, text_col: str = "text", label_col: str = "label",
                 ) -> "TextSet":
        """``readCSV`` (``TextSet.scala:345``)."""
        feats = []
        with open(path, newline="", encoding="utf-8") as fh:
            for row in csv.DictReader(fh):
                label = row.get(label_col)
                feats.append(TextFeature(
                    row[text_col], int(label) if label not in (None, "") else None))
        return TextSet(feats)

    @staticmethod
    def from_parquet(path: str, text_col: str = "text",
                     label_col: str = "label") -> "TextSet":
        """``readParquet`` (``TextSet.scala:372``) — columnar corpora via
        pyarrow, imported here (a clear error when it is missing)."""
        try:
            import pyarrow.parquet as pq
        except ImportError as e:  # pragma: no cover - env without pyarrow
            raise ImportError(
                "TextSet.from_parquet needs pyarrow; install it or convert "
                "the corpus to csv for TextSet.from_csv") from e
        cols = set(pq.read_schema(path).names)
        if text_col not in cols:
            raise ValueError(f"{path}: no column {text_col!r} "
                             f"(have {sorted(cols)})")
        wanted = [text_col] + ([label_col] if label_col in cols else [])
        table = pq.read_table(path, columns=wanted)  # skip unused columns
        texts = table.column(text_col).to_pylist()
        labels = (table.column(label_col).to_pylist()
                  if label_col in cols else [None] * len(texts))
        feats = []
        for i, (t, l) in enumerate(zip(texts, labels)):
            if t is None:
                raise ValueError(
                    f"{path}: null text at row {i} — clean the corpus or "
                    f"drop null rows before loading")
            feats.append(TextFeature(t, None if l is None else int(l)))
        return TextSet(feats)

    # ---- protocol ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self.features)

    @property
    def labels(self) -> Optional[np.ndarray]:
        if any(f.label is None for f in self.features):
            return None
        return np.asarray([f.label for f in self.features], np.int32)

    # ---- transformers -----------------------------------------------------
    def tokenize(self) -> "TextSet":
        """``Tokenizer.scala``: lowercase, strip punctuation, whitespace
        split (the reference chains Normalizer the same way)."""
        for f in self.features:
            cleaned = _PUNCT_RE.sub(" ", f.text.lower())
            f.tokens = cleaned.split()
        return self

    def word2idx(self, remove_top_n: int = 0,
                 max_words_num: int = -1,
                 existing_map: Optional[Dict[str, int]] = None) -> "TextSet":
        """``WordIndexer`` (``TextSet.scala:147``): build (or reuse) the
        frequency vocabulary; 1-based indices, 0 = padding/OOV. The
        ``remove_top_n`` most frequent words are dropped (stop-word
        heuristic), capped at ``max_words_num`` words."""
        if any(f.tokens is None for f in self.features):
            raise RuntimeError("call tokenize() before word2idx()")
        if existing_map is not None:
            self.word_index = dict(existing_map)
        else:
            counts = collections.Counter()
            for f in self.features:
                counts.update(f.tokens)
            ranked = [w for w, _ in counts.most_common()]
            ranked = ranked[remove_top_n:]
            if max_words_num > 0:
                ranked = ranked[:max_words_num]
            self.word_index = {w: i + 1 for i, w in enumerate(ranked)}
        wi = self.word_index
        for f in self.features:
            f.indices = np.asarray([wi.get(t, 0) for t in f.tokens], np.int32)
        return self

    def shape_sequence(self, length: int, trunc_mode: str = "pre",
                       pad_element: int = 0) -> "TextSet":
        """``SequenceShaper.scala``: pad (post) / truncate to ``length``.
        ``trunc_mode='pre'`` keeps the LAST ``length`` tokens (the
        reference's default), 'post' keeps the first."""
        if trunc_mode not in ("pre", "post"):
            raise ValueError("trunc_mode must be 'pre' or 'post'")
        for f in self.features:
            if f.indices is None:
                raise RuntimeError("call word2idx() before shape_sequence()")
            idx = f.indices
            if len(idx) > length:
                idx = idx[-length:] if trunc_mode == "pre" else idx[:length]
            elif len(idx) < length:
                idx = np.concatenate(
                    [idx, np.full(length - len(idx), pad_element, np.int32)])
            f.indices = idx
        return self

    def generate_sample(self) -> FeatureSet:
        """``TextFeatureToSample`` (``TextSet.scala:177``): dense arrays into
        the training FeatureSet."""
        if any(f.indices is None for f in self.features):
            raise RuntimeError("run tokenize/word2idx/shape_sequence first")
        lens = {len(f.indices) for f in self.features}
        if len(lens) != 1:
            raise ValueError(f"ragged sequences {sorted(lens)}; call "
                             "shape_sequence(length) first")
        x = np.stack([f.indices for f in self.features])
        return FeatureSet.array(x, self.labels)

    def to_arrays(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        fs = self.generate_sample()
        return fs.x, fs.y

    def to_bucketed(self, lengths, trunc_mode: str = "pre",
                    shuffle: bool = True, seed: int = 0
                    ) -> BucketedFeatureSet:
        """Length-bucketed alternative to ``shape_sequence`` + one
        FeatureSet: each text pads to the SMALLEST bucket length that fits
        it (the longest bucket truncates), so short texts stop paying
        full-length padding compute. Returns a ``BucketedFeatureSet``."""
        if trunc_mode not in ("pre", "post"):
            raise ValueError("trunc_mode must be 'pre' or 'post'")
        lengths = sorted({int(ln) for ln in lengths})
        if not lengths:
            raise ValueError("need at least one bucket length")
        groups: Dict[int, Tuple[list, list]] = {ln: ([], [])
                                               for ln in lengths}
        for f in self.features:
            if f.indices is None:
                raise RuntimeError("call tokenize() and word2idx() first")
            idx = np.asarray(f.indices, np.int32)
            ln = next((b for b in lengths if len(idx) <= b), lengths[-1])
            if len(idx) > ln:
                idx = idx[-ln:] if trunc_mode == "pre" else idx[:ln]
            elif len(idx) < ln:
                idx = np.concatenate(
                    [idx, np.zeros(ln - len(idx), np.int32)])
            xs, ys = groups[ln]
            xs.append(idx)
            ys.append(f.label)
        buckets = []
        for ln in lengths:
            xs, ys = groups[ln]
            if not xs:
                continue
            y = (np.asarray(ys, np.int32)
                 if all(v is not None for v in ys) else None)
            buckets.append(FeatureSet(np.stack(xs), y, shuffle=shuffle,
                                      seed=seed))
        return BucketedFeatureSet(buckets, shuffle=shuffle, seed=seed)

    def get_word_index(self) -> Dict[str, int]:
        if self.word_index is None:
            raise RuntimeError("word2idx() has not run")
        return self.word_index

