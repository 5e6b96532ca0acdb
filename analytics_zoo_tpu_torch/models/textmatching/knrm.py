"""KNRM — port of ``analytics_zoo_tpu/models/textmatching/knrm.py``:
kernel-pooling neural ranking for text matching, parity with
``models/textmatching/KNRM.scala:60`` (pyzoo ``models/textmatching/knrm.py:32``).

Topology (identical to the reference): concatenated [query ids, doc ids]
(B, text1_length + text2_length) → shared embedding → split → translation
matrix of cosine-free dot products (batchDot axes=(2,2)) → per-kernel RBF
soft-TF counts (mu sweeping -0.9..1.0, exact-match kernel at mu=1 with
exact_sigma) → log-sum pooling over doc then query → Dense(1)
(sigmoid for classification mode).

The kernel pooling is a ``Lambda`` over torch ops in f32: one batched
product and one broadcast elementwise expression over a (B, T1, T2, K)
tensor. No hand-written kernel lies on this path (the JAX package leaves
it to XLA). The layers get the JAX package's names, so
``load_jax_params`` moves a JAX KNRM's weights across name for name.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ...pipeline.api.keras.engine import Input, Lambda, Model, unique_name
from ...pipeline.api.keras.layers import Dense, Embedding, WordEmbedding
from ..common.ranker import RankerMixin
from ..common.zoo_model import ZooModel, register_model


def kernel_grid(kernel_num: int, sigma: float, exact_sigma: float):
    """``(mus, sigmas)`` as f32 arrays, the mu grid of ``KNRM.scala:86-92``:
    ``kernel_num`` kernels sweeping -0.9..1.0, the one past 1.0 the
    exact-match kernel at mu = 1 with ``exact_sigma``."""
    mus, sigmas = [], []
    for i in range(kernel_num):
        mu = 1.0 / (kernel_num - 1) + (2.0 * i) / (kernel_num - 1) - 1.0
        if mu > 1.0:
            mus.append(1.0)
            sigmas.append(exact_sigma)
        else:
            mus.append(mu)
            sigmas.append(sigma)
    return np.asarray(mus, np.float32), np.asarray(sigmas, np.float32)


class KernelPool:
    """The kernel pooling of the embedded [query ++ doc] rows ``e`` (B, T1
    + T2, E) → (B, K), in f32. The grid is made a tensor once a device
    (outside a captured step: its warm-up step runs first)."""

    def __init__(self, text1_length: int, mus: np.ndarray,
                 sigmas: np.ndarray):
        self.t1 = text1_length
        self.mus, self.sigmas = mus, sigmas
        self._grid: Dict[Any, tuple] = {}

    def __call__(self, e: torch.Tensor) -> torch.Tensor:
        grid = self._grid.get(e.device)
        if grid is None:
            grid = self._grid[e.device] = (
                torch.from_numpy(self.mus).to(e.device),
                torch.from_numpy(self.sigmas).to(e.device))
        mu, sig = grid
        q = e[:, :self.t1, :].float()
        d = e[:, self.t1:, :].float()
        mm = torch.einsum("bqe,bde->bqd", q, d)        # translation matrix
        diff = mm[..., None] - mu
        rbf = torch.exp(-0.5 * (diff / sig) ** 2)      # (B, T1, T2, K)
        soft_tf = torch.sum(rbf, dim=2)                # sum over doc
        logs = torch.log1p(soft_tf)                    # log(1 + x)
        return torch.sum(logs, dim=1)                  # (B, K)


@register_model
class KNRM(RankerMixin, ZooModel):
    """``KNRM(text1Length, text2Length, vocabSize, embedSize, kernelNum,
    sigma, exactSigma, targetMode)``; ``device`` is where the weights live
    (``cuda`` unless given)."""

    def __init__(self, text1_length: int, text2_length: int,
                 vocab_size: int, embed_size: int = 300,
                 embed_weights: Optional[np.ndarray] = None,
                 train_embed: bool = True, kernel_num: int = 21,
                 sigma: float = 0.1, exact_sigma: float = 0.001,
                 target_mode: str = "ranking", name: Optional[str] = None,
                 device=None):
        if kernel_num <= 1:
            raise ValueError(f"kernel_num must be > 1, got {kernel_num}")
        if target_mode not in ("ranking", "classification"):
            raise ValueError(f"target_mode must be ranking|classification, "
                             f"got {target_mode!r}")
        self.text1_length = int(text1_length)
        self.text2_length = int(text2_length)
        self.vocab_size = int(vocab_size)
        self.embed_size = int(embed_size)
        self.embed_weights = (np.asarray(embed_weights, np.float32)
                              if embed_weights is not None else None)
        self.train_embed = bool(train_embed)
        self.kernel_num = int(kernel_num)
        self.sigma = float(sigma)
        self.exact_sigma = float(exact_sigma)
        self.target_mode = target_mode
        super().__init__(name=name, device=device)

    def build_model(self) -> Model:
        t1, t2 = self.text1_length, self.text2_length
        inp = Input(shape=(t1 + t2,))
        if self.embed_weights is not None:
            embed = WordEmbedding(self.embed_weights,
                                  trainable=self.train_embed)(inp)
        else:
            embed = Embedding(self.vocab_size, self.embed_size,
                              init="uniform")(inp)
        pool = KernelPool(t1, *kernel_grid(self.kernel_num, self.sigma,
                                           self.exact_sigma))
        phi = Lambda(pool, name=unique_name("kernelpool_"))(embed)
        if self.target_mode == "ranking":
            out = Dense(1, init="uniform")(phi)
        else:
            out = Dense(1, init="uniform", activation="sigmoid")(phi)
        return Model(inp, out, device=self.device)

    def get_config(self) -> Dict[str, Any]:
        return {"text1_length": self.text1_length,
                "text2_length": self.text2_length,
                "vocab_size": self.vocab_size,
                "embed_size": self.embed_size,
                "train_embed": self.train_embed,
                "kernel_num": self.kernel_num,
                "sigma": self.sigma,
                "exact_sigma": self.exact_sigma,
                "target_mode": self.target_mode}

    def extra_arrays(self):
        # only the FROZEN path needs the constructor table back at load time;
        # a trainable table lives in (and is restored from) the p_ leaves,
        # and after training it no longer dedups against the original
        if self.embed_weights is not None and not self.train_embed:
            return {"embed_weights": self.embed_weights}
        return {}
