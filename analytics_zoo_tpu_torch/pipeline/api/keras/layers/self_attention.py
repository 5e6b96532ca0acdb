"""Transformer layers — port of ``analytics_zoo_tpu/pipeline/api/keras/
layers/self_attention.py``: ``MultiHeadSelfAttention`` (fused QKV, routed
to the flash kernel or the oracle), the post-LN ``TransformerBlock``, the
GPT-style ``TransformerLayer`` and the ``BERT`` encoder.

On a device mesh (``parallel/mesh.py``) the layers run the JAX package's
shardings as explicit collectives. Tensor parallelism over ``model`` is
Megatron's: the fused QKV projection column-parallel (each rank's block
holds whole heads of q, k and v), attention on the rank's heads, the
output projection row-parallel with one all-reduce after it; the MLP's
``fc`` column-parallel and ``out`` row-parallel with one all-reduce; the
embedding tables split over their hidden dimension and gathered after the
lookup. Sequence parallelism over ``seq`` routes attention through the
ring or Ulysses (``parallel/ring_attention.py``; ``zoo.seq.mode``, or the
training loop's ``zoo.train.seq_attention``), the activations whole on
every rank outside it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .....common.noise import split_generators
from .....ops.attention import dot_product_attention, merge_heads, split_heads
from .....parallel.collectives import copy_to, gather_from, reduce_from
from .....parallel.mesh import MODEL_AXIS, sharded_over
from ..engine import Layer, compute_dtype, get_initializer, param_dtype
from .core import dense, dropout
from .embeddings import take_rows
from .normalization import LayerNorm


class DenseParams(Layer):
    """A bare ``{"W", "b"}`` projection inside a transformer layer (the
    JAX package's ``_dense_params``/``_dense`` pair). Under weight-only
    int8 inference ``W`` is int8 beside its ``w_scale`` and the product
    runs K6 through ``dense``. It has no ``quantized_call``: the JAX
    package's static int8 never sees these products (they are not
    container-dispatched layers)."""

    def __init__(self, d_in: int, d_out: int, init: str = "glorot_uniform",
                 **kwargs):
        super().__init__(**kwargs)
        self.d_in, self.d_out, self.init = d_in, d_out, init

    def build(self, input_shape=None, *, generator):
        self.add_weight("W", get_initializer(self.init)(
            generator, (self.d_in, self.d_out), param_dtype()))
        self.add_weight("b", torch.zeros(self.d_out, dtype=param_dtype()))

    def call(self, x, *, training=False, generator=None):
        return dense(x, self.W, self.b, compute_dtype(),
                     getattr(self, "w_scale", None))


def _split_generator(generator: Optional[torch.Generator], n: int):
    """``n`` generators for ``n`` noise sites (``noise.split_generators``):
    split CPU generators, or a device generator shared in program
    order."""
    return split_generators(generator, n)


class MultiHeadSelfAttention(Layer):
    """Fused-QKV multi-head self-attention. Input ``(B, T, H)``, or
    ``[x, mask]`` with a ``(B, 1, 1, T)`` or ``(B, T)`` keep-mask, →
    ``(B, T, H)``."""

    #: ``zoo.pallas.attention=auto`` hands sequences at least this long on
    #: a CUDA device to the flash kernel. The crossover against the oracle
    #: on the H100 has not been measured; 2048 is the JAX package's value.
    FLASH_AUTO_MIN_SEQ = 2048

    def __init__(self, hidden_size: int, n_head: int, causal: bool = False,
                 attn_drop: float = 0.0, out_drop: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        if hidden_size % n_head != 0:
            raise ValueError(f"hidden_size {hidden_size} not divisible by "
                             f"n_head {n_head}")
        self.hidden_size = hidden_size
        self.n_head = n_head
        self.causal = causal
        self.attn_drop = attn_drop
        self.out_drop = out_drop
        self.qkv = DenseParams(hidden_size, 3 * hidden_size)
        self.proj = DenseParams(hidden_size, hidden_size)

    def build(self, input_shape=None, *, generator):
        self.qkv.build(generator=generator)
        self.proj.build(generator=generator)

    def compute_output_shape(self, input_shape):
        shape = (input_shape[0] if isinstance(input_shape, list)
                 else input_shape)
        return tuple(shape[:-1]) + (self.hidden_size,)

    @staticmethod
    def _kv_mask(mask):
        """The ``(B, Tk)`` key-padding form of a broadcastable mask, or
        None when it is genuinely per-query."""
        if mask is None:
            return None
        if mask.dim() == 2:
            return mask
        if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
            return mask[:, 0, 0, :]
        return None

    def _use_flash(self, mask, drop: float, seq_len: int,
                   device: torch.device) -> bool:
        """The flash kernel covers key-padding and mask-free attention
        without dropout. ``zoo.pallas.attention``: true/false force it;
        ``auto`` takes it on a CUDA device for ``seq_len >=
        FLASH_AUTO_MIN_SEQ``."""
        if drop > 0.0:
            return False
        if mask is not None and self._kv_mask(mask) is None:
            return False
        from .....common.context import tri_state_conf
        flag = tri_state_conf("zoo.pallas.attention")
        if flag == "auto":
            return device.type == "cuda" and seq_len >= self.FLASH_AUTO_MIN_SEQ
        return flag

    def param_sharding(self, mesh=None):
        """Megatron attention TP: the fused QKV column-parallel, its
        ``[q|k|v]`` dimension split block by block so each rank keeps
        whole heads of all three (the JAX spec splits the fused dimension
        as one; the arithmetic is the same), the output projection
        row-parallel. Replicated where the heads do not divide the
        ``model`` axis."""
        n = 1 if mesh is None else mesh.shape[MODEL_AXIS]
        if self.n_head % n:
            return {}
        return {"qkv.W": (None, (MODEL_AXIS, 3)),
                "qkv.b": ((MODEL_AXIS, 3),), "proj.W": (MODEL_AXIS, None)}

    def _seq_fallback(self, reason: str):
        """A seq mesh exists but this call cannot ride it: warn once, or
        raise under ``zoo.seq.strict`` or a loop-forced mode (JAX
        ``_seq_fallback``)."""
        from .....common.context import get_zoo_context
        from ..seq_pipe import forced_seq_mode
        strict = bool(get_zoo_context().get("zoo.seq.strict", False))
        if strict or forced_seq_mode() in ("ring", "ulysses"):
            raise RuntimeError(
                f"{self.name}: zoo.seq.strict is set and {reason} — "
                f"attention cannot ride the seq mesh (it would silently "
                f"fall back to full attention)")
        if not getattr(self, "_warned_no_ring", False):
            import logging
            logging.getLogger("analytics_zoo_tpu_torch.attention").warning(
                "%s: seq-axis mesh active but %s — full O(T^2) attention "
                "for this layer (no sequence parallelism)", self.name,
                reason)
            self._warned_no_ring = True
        return None

    def _ring_mesh(self, mask, drop, seq_len, generator):
        """The mesh whose ``seq`` axis this call's attention splits over
        (JAX ``_ring_mesh``), or None: no seq axis, a pipeline stage's
        scope, or a call that cannot ride it (a per-query mask, dropout
        without a generator, a sequence the axis does not divide)."""
        from .....parallel import mesh as mesh_lib
        from ..seq_pipe import forced_seq_mode
        if forced_seq_mode() == "off":
            return None
        mesh = mesh_lib.global_mesh()
        n_seq = mesh.shape[mesh_lib.SEQ_AXIS]
        if n_seq <= 1:
            return None
        if drop > 0.0 and generator is None:
            return self._seq_fallback(
                f"attn_drop={drop} with no generator (training without "
                f"one cannot draw in-ring dropout masks)")
        if mask is not None and self._kv_mask(mask) is None:
            return self._seq_fallback(
                "the mask is per-query (not reducible to (B, Tk) "
                "key-padding form)")
        if seq_len % n_seq == 0:
            return mesh
        return self._seq_fallback(
            f"shapes can't split (T={seq_len} over seq={n_seq})")

    def _seq_routing(self, n_seq: int, n_head: int) -> str:
        """``zoo.seq.mode``: ``ring`` (default), ``ulysses``, or ``auto``
        (ulysses when the heads divide the seq axis); a loop-forced mode
        (``zoo.train.seq_attention``) wins (JAX ``_seq_routing``)."""
        from .....common.context import get_zoo_context
        from ..seq_pipe import forced_seq_mode
        forced = forced_seq_mode()
        mode = (forced if forced in ("ring", "ulysses") else
                str(get_zoo_context().get("zoo.seq.mode", "ring")).lower())
        if mode not in ("ring", "ulysses", "auto"):
            raise ValueError(f"zoo.seq.mode must be ring|ulysses|auto, "
                             f"got {mode!r}")
        if mode == "ulysses" and n_head % n_seq != 0:
            raise ValueError(
                f"zoo.seq.mode=ulysses needs n_head ({n_head}) divisible "
                f"by the seq axis ({n_seq})")
        if mode == "auto":
            mode = "ulysses" if n_head % n_seq == 0 else "ring"
        return mode

    def call(self, x, *, training=False, generator=None):
        mask = None
        if isinstance(x, (list, tuple)):
            x, mask = x
        ax = sharded_over(self.qkv.W, MODEL_AXIS)
        n_head = self.n_head if ax is None else self.n_head // ax.size
        qkv = self.qkv(copy_to(x, ax))
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        g1, g2 = _split_generator(generator, 2)
        qh, kh, vh = (split_heads(a, n_head) for a in (q, k, v))
        drop = self.attn_drop if training else 0.0
        seq_mesh = self._ring_mesh(mask, drop, qh.shape[2], g1)
        if seq_mesh is not None:
            from .....parallel import mesh as mesh_lib
            from .....parallel.ring_attention import (ring_self_attention,
                                                      ulysses_self_attention)
            kv_mask = self._kv_mask(mask)
            n_seq = seq_mesh.shape[mesh_lib.SEQ_AXIS]
            if self._seq_routing(n_seq, n_head) == "ulysses":
                out = ulysses_self_attention(
                    qh, kh, vh, mesh=seq_mesh, causal=self.causal,
                    mask=kv_mask, dropout_rate=drop,
                    generator=g1 if drop > 0.0 else None,
                    flash=self._use_flash(mask, drop, qh.shape[2],
                                          qh.device))
            else:
                out = ring_self_attention(
                    qh, kh, vh, mesh=seq_mesh, causal=self.causal,
                    mask=None if kv_mask is None else kv_mask.bool(),
                    dropout_rate=drop,
                    generator=g1 if drop > 0.0 else None)
        elif self._use_flash(mask, drop, qh.shape[2], qh.device):
            # under autograd this is the kernels' autograd Function: K2
            # with the lse forward, K3a + K3b backward
            from .....ops.pallas import flash_attention
            out = flash_attention(qh.contiguous(), kh.contiguous(),
                                  vh.contiguous(), mask=self._kv_mask(mask),
                                  causal=self.causal)
        else:
            out = dot_product_attention(qh, kh, vh, mask=mask,
                                        causal=self.causal,
                                        dropout_rate=drop, generator=g1)
        if ax is None:
            out = self.proj(merge_heads(out))
        else:
            # row-parallel: the rank's heads' share of the product, summed
            cd = compute_dtype()
            out = (reduce_from(torch.matmul(merge_heads(out).to(cd),
                                            self.proj.W.to(cd)), ax)
                   + self.proj.b.to(cd))
        return dropout(out, self.out_drop, g2, training)


class TransformerBlock(Layer):
    """Post-LN residual block: ``x = LN1(x + Attn(x)); x = LN2(x +
    FFN(x))``, FFN = gelu (tanh form by default; BERT uses the erf
    form)."""

    def __init__(self, hidden_size: int, n_head: int,
                 intermediate_size: Optional[int] = None,
                 causal: bool = False, hidden_drop: float = 0.0,
                 attn_drop: float = 0.0, epsilon: float = 1e-5,
                 gelu_approximate: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.hidden_drop = hidden_drop
        self.gelu_approximate = gelu_approximate
        self.attn = MultiHeadSelfAttention(
            hidden_size, n_head, causal=causal, attn_drop=attn_drop,
            out_drop=hidden_drop, name=f"{self.name}_attn")
        self.ln1 = LayerNorm(epsilon=epsilon)
        self.fc = DenseParams(hidden_size, self.intermediate_size)
        self.out = DenseParams(self.intermediate_size, hidden_size)
        self.ln2 = LayerNorm(epsilon=epsilon)

    def build(self, input_shape=None, *, generator):
        shape = (None, None, self.hidden_size)
        self.attn.build(generator=generator)
        self.ln1.build(shape, generator=generator)
        self.fc.build(generator=generator)
        self.out.build(generator=generator)
        self.ln2.build(shape, generator=generator)

    def compute_output_shape(self, input_shape):
        return input_shape[0] if isinstance(input_shape, list) else input_shape

    def call(self, x, *, training=False, generator=None):
        mask = None
        if isinstance(x, (list, tuple)):
            x, mask = x
        g1, g2 = _split_generator(generator, 2)
        a = self.attn([x, mask] if mask is not None else x,
                      training=training, generator=g1)
        x = self.ln1(x + a)
        ax = sharded_over(self.fc.W, MODEL_AXIS)
        h = F.gelu(self.fc(copy_to(x, ax)),
                   approximate="tanh" if self.gelu_approximate else "none")
        if ax is None:
            h = self.out(h)
        else:
            # row-parallel: the rank's share of the product, summed
            cd = compute_dtype()
            h = (reduce_from(torch.matmul(h.to(cd), self.out.W.to(cd)), ax)
                 + self.out.b.to(cd))
        h = dropout(h, self.hidden_drop, g2, training)
        return self.ln2(x + h)

    def param_sharding(self, mesh=None):
        """Megatron MLP TP: ``fc`` column-parallel, ``out`` row-parallel
        (the attention declares its own); LayerNorms replicated."""
        return {"fc.W": (None, MODEL_AXIS), "fc.b": (MODEL_AXIS,),
                "out.W": (MODEL_AXIS, None)}


class TransformerLayer(Layer):
    """GPT-style decoder stack — ``TransformerLayer.scala:56``. Input int
    ids ``(B, T)`` → hidden states ``(B, T, H)``; ``bidirectional=False``
    makes every block causal. Blocks keep the JAX defaults: intermediate
    ``4 H``, LayerNorm epsilon 1e-5, tanh gelu."""

    def __init__(self, vocab: int, seq_len: int, n_block: int = 12,
                 hidden_size: int = 768, n_head: int = 12,
                 hidden_drop: float = 0.1, attn_drop: float = 0.1,
                 embedding_drop: float = 0.1, bidirectional: bool = False,
                 initializer_range: float = 0.02, **kwargs):
        super().__init__(**kwargs)
        self.vocab = vocab
        self.seq_len = seq_len
        self.n_block = n_block
        self.hidden_size = hidden_size
        self.embedding_drop = embedding_drop
        self.initializer_range = initializer_range
        for i in range(n_block):
            # attribute names are the JAX tree's keys: block0, block1, ...
            self.add_module(f"block{i}", TransformerBlock(
                hidden_size, n_head, causal=not bidirectional,
                hidden_drop=hidden_drop, attn_drop=attn_drop,
                name=f"{self.name}_block{i}"))

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.n_block)]

    def param_sharding(self, mesh=None):
        """The token and position tables over their hidden dimension (the
        blocks declare their own; JAX ``_stack_param_sharding``)."""
        return {"wte": (None, MODEL_AXIS), "wpe": (None, MODEL_AXIS)}

    def compute_output_shape(self, input_shape):
        return (input_shape[0], input_shape[1], self.hidden_size)

    def build(self, input_shape=None, *, generator):
        std = self.initializer_range

        def table(rows):
            return torch.empty(rows, self.hidden_size).normal_(
                generator=generator).mul_(std).to(param_dtype())

        self.add_weight("wte", table(self.vocab))
        self.add_weight("wpe", table(self.seq_len))
        for blk in self.blocks():
            blk.build(generator=generator)

    def call(self, x, *, training=False, generator=None):
        t = x.shape[1]
        # unlike BERT, the JAX layer gathers and adds in the param dtype and
        # casts the sum to the compute dtype afterwards
        h = (take_rows(self.wte, x) + self.wpe[None, :t, :]).to(
            compute_dtype())
        h = gather_from(h, sharded_over(self.wte, MODEL_AXIS), -1)
        gens = _split_generator(generator, self.n_block + 1)
        h = dropout(h, self.embedding_drop, gens[0], training)
        for blk, g in zip(self.blocks(), gens[1:]):
            h = blk(h, training=training, generator=g)
        return h


class BERT(Layer):
    """BERT encoder. Input ``[token_ids, token_type_ids, position_ids,
    attention_mask]`` (mask ``(B, T)`` or ``(B, 1, 1, T)``, 1.0 = attend)
    → ``[sequence_output, pooled_output]``."""

    def __init__(self, vocab: int = 40990, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12, seq_len: int = 512,
                 intermediate_size: int = 3072, hidden_drop: float = 0.1,
                 attn_drop: float = 0.1, initializer_range: float = 0.02,
                 type_vocab: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.vocab = vocab
        self.hidden_size = hidden_size
        self.n_block = n_block
        self.seq_len = seq_len
        self.type_vocab = type_vocab
        self.hidden_drop = hidden_drop
        self.initializer_range = initializer_range
        self.emb_ln = LayerNorm(epsilon=1e-12)
        self.pooler = DenseParams(hidden_size, hidden_size)
        for i in range(n_block):
            # attribute names are the JAX tree's keys: block0, block1, ...
            self.add_module(f"block{i}", TransformerBlock(
                hidden_size, n_head, intermediate_size=intermediate_size,
                causal=False, hidden_drop=hidden_drop, attn_drop=attn_drop,
                epsilon=1e-12, gelu_approximate=False,
                name=f"{self.name}_block{i}"))

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.n_block)]

    def param_sharding(self, mesh=None):
        """The three embedding tables over their hidden dimension (the
        blocks declare their own; JAX ``_stack_param_sharding``)."""
        return {name: (None, MODEL_AXIS)
                for name in ("word", "position", "token_type")}

    def build(self, input_shape=None, *, generator):
        std = self.initializer_range

        def table(rows):
            return torch.empty(rows, self.hidden_size).normal_(
                generator=generator).mul_(std).to(param_dtype())

        self.add_weight("word", table(self.vocab))
        self.add_weight("position", table(self.seq_len))
        self.add_weight("token_type", table(self.type_vocab))
        self.emb_ln.build((None, None, self.hidden_size), generator=generator)
        self.pooler.build(generator=generator)
        for blk in self.blocks():
            blk.build(generator=generator)

    def call(self, x, *, training=False, generator=None):
        if not isinstance(x, (list, tuple)) or len(x) != 4:
            raise ValueError(f"{self.name}: BERT expects [token_ids, "
                             f"token_type_ids, position_ids, attention_mask]")
        ids, token_type, pos, mask = x
        cd = compute_dtype()
        # tables are cast to the compute dtype BEFORE the gather, as in
        # the JAX package (a no-op when the weights already are)
        h = (take_rows(self.word.to(cd), ids)
             + take_rows(self.position.to(cd), pos)
             + take_rows(self.token_type.to(cd), token_type))
        h = gather_from(h, sharded_over(self.word, MODEL_AXIS), -1)
        h = self.emb_ln(h).to(cd)
        gens = _split_generator(generator, self.n_block + 1)
        h = dropout(h, self.hidden_drop, gens[0], training)
        if mask is not None and mask.dim() == 2:
            mask = mask[:, None, None, :]
        for blk, g in zip(self.blocks(), gens[1:]):
            h = blk([h, mask], training=training, generator=g)
        pooled = torch.tanh(self.pooler(h[:, 0, :]))
        return [h, pooled]
