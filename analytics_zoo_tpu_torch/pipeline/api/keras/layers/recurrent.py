"""Recurrent layers — port of ``analytics_zoo_tpu/pipeline/api/keras/
layers/recurrent.py``: ``SimpleRNN``, ``LSTM``, ``GRU`` and
``Bidirectional``, with the JAX package's Keras-1 weight layout (``W``
``(D, gates·U)``, ``U`` ``(U, gates·U)``, ``b``; gate order i, f, c, o for
LSTM and z, r, h for GRU).

Neither ``nn.LSTM``/``nn.GRU`` nor cuDNN's fused RNN computes these
layers: Keras-1's ``inner_activation`` defaults to ``hard_sigmoid``, and
the GRU applies its reset gate *before* the recurrent product. So the step
runs as torch ops, one time step at a time; on the card a captured fit
(``zoo.train.scan_steps``) replays the steps' launches from a CUDA graph.

The arithmetic is the JAX layer's, in its dtypes:

* the input projection for every step at once, ``x W`` in f32 over the
  operands rounded to the compute dtype (``preferred_element_type=f32``:
  no rounding of the product) plus ``b`` in f32;
* the carry is f32, so ``h U`` promotes ``U`` (rounded to the compute
  dtype) to f32, and the cell state stays f32;
* only the emitted hidden states are cast to the compute dtype.

``go_backwards`` runs the sequence reversed; with ``return_sequences``
the states are flipped back into input order, without it the output is
the last processed step. ``run(x, carry0)`` returns the states and the
final carry (``(h, c)`` for LSTM), which ``Seq2seq`` hands to its decoder
through its bridge.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import torch

from ..engine import Layer, compute_dtype, get_initializer, param_dtype
from .core import get_activation


def _promoted(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``w`` in the dtype jnp's ``like @ w`` computes in."""
    return w.to(torch.promote_types(like.dtype, w.dtype))


class _RecurrentBase(Layer):
    """Shapes, the input projection, the time loop, ``return_sequences``
    and ``go_backwards``; subclasses define ``n_gates`` and
    ``step(U, carry, z_t) -> (carry, h)``."""

    n_gates = 1

    def __init__(self, output_dim: int, activation="tanh",
                 init: str = "glorot_uniform",
                 inner_init: str = "orthogonal",
                 return_sequences: bool = False, go_backwards: bool = False,
                 **kwargs):
        super().__init__(**kwargs)
        self.output_dim = output_dim
        self.activation = get_activation(activation)
        self.init = init
        self.inner_init = inner_init
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def build(self, input_shape, *, generator):
        d, u = input_shape[-1], self.output_dim
        self.add_weight("W", get_initializer(self.init)(
            generator, (d, self.n_gates * u), param_dtype()))
        self.add_weight("U", get_initializer(self.inner_init)(
            generator, (u, self.n_gates * u), param_dtype()))
        self.add_weight("b", torch.zeros(self.n_gates * u,
                                         dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        if self.return_sequences:
            return (input_shape[0], input_shape[1], self.output_dim)
        return (input_shape[0], self.output_dim)

    def initial_carry(self, batch: int, device) -> torch.Tensor:
        return torch.zeros(batch, self.output_dim, dtype=torch.float32,
                           device=device)

    def _steps(self, x: torch.Tensor, carry0):
        """The time loop: ``(per-step hidden states (f32), final carry)``
        over ``x`` in processing order."""
        cd = compute_dtype()
        x = x.to(cd)
        if self.go_backwards:
            x = x.flip(1)
        # one (B*T, D) product for every step; f32, unrounded, + f32 b
        zx = torch.matmul(x.float(), self.W.to(cd).float()) + self.b.float()
        carry = (carry0 if carry0 is not None
                 else self.initial_carry(x.shape[0], x.device))
        U = self.U.to(cd)
        hs: List[torch.Tensor] = []
        # unbind: its backward is one stack, where indexing zx[:, t]
        # would build a full-size zero gradient for every step
        for z_t in zx.unbind(1):
            carry, h = self.step(U, carry, z_t)
            hs.append(h)
        return hs, carry

    def run(self, x: torch.Tensor, carry0=None):
        """The whole scan: ``(hidden states (B, T, U) in the compute dtype,
        in processing order; final carry)``. ``carry0`` lets a decoder
        start from bridged encoder states."""
        hs, carry = self._steps(x, carry0)
        return torch.stack(hs, 1).to(compute_dtype()), carry

    def call(self, x, *, training=False, generator=None):
        hs, _ = self._steps(x, None)
        if not self.return_sequences:
            return hs[-1].to(compute_dtype())
        seq = torch.stack(hs, 1).to(compute_dtype())
        return seq.flip(1) if self.go_backwards else seq


class SimpleRNN(_RecurrentBase):
    """``SimpleRNN.scala``: ``h_t = act(x_t W + h_{t-1} U + b)``."""

    n_gates = 1

    def step(self, U, h, z_t):
        h = self.activation(torch.addmm(z_t, h, _promoted(U, h)))
        return h, h


class LSTM(_RecurrentBase):
    """``LSTM.scala``, Keras-1 gates (i, f, c, o): ``i = σ(z_i)``, ``f =
    σ(z_f)``, ``c = f c' + i tanh(z_c)``, ``o = σ(z_o)``, ``h = o act(c)``
    with ``z = x W + h' U + b`` and σ the ``inner_activation``."""

    n_gates = 4

    def __init__(self, output_dim: int, activation="tanh",
                 inner_activation="hard_sigmoid", **kwargs):
        super().__init__(output_dim, activation=activation, **kwargs)
        self.inner_activation = get_activation(inner_activation)

    def initial_carry(self, batch: int, device):
        z = super().initial_carry(batch, device)
        return (z, z)

    def step(self, U, carry, z_t):
        h_prev, c_prev = carry
        u = self.output_dim
        z = torch.addmm(z_t, h_prev, _promoted(U, h_prev))
        i = self.inner_activation(z[:, :u])
        f = self.inner_activation(z[:, u:2 * u])
        g = torch.tanh(z[:, 2 * u:3 * u])
        o = self.inner_activation(z[:, 3 * u:])
        c = f * c_prev + i * g
        h = o * self.activation(c)
        return (h, c), h


class GRU(_RecurrentBase):
    """``GRU.scala``, Keras-1 gates (z, r, h) with the reset gate applied
    before the recurrent product: ``hh = act(x W_h + (r h') U_h + b_h)``,
    ``h = z h' + (1 - z) hh``."""

    n_gates = 3

    def __init__(self, output_dim: int, activation="tanh",
                 inner_activation="hard_sigmoid", **kwargs):
        super().__init__(output_dim, activation=activation, **kwargs)
        self.inner_activation = get_activation(inner_activation)

    def step(self, U, h_prev, z_t):
        u = self.output_dim
        U = _promoted(U, h_prev)
        zr = torch.addmm(z_t[:, :2 * u], h_prev, U[:, :2 * u])
        z = self.inner_activation(zr[:, :u])
        r = self.inner_activation(zr[:, u:])
        hh = self.activation(torch.addmm(z_t[:, 2 * u:], r * h_prev,
                                         U[:, 2 * u:]))
        h = z * h_prev + (1.0 - z) * hh
        return h, h


_MERGE = {"concat": lambda a, b: torch.cat([a, b], dim=-1),
          "sum": lambda a, b: a + b,
          "mul": lambda a, b: a * b,
          "ave": lambda a, b: (a + b) / 2.0}


class Bidirectional(Layer):
    """``Bidirectional.scala``: the recurrent layer forward and a copy of
    it (named ``<name>_bwd``, ``go_backwards`` flipped) with weights of
    its own, merged by ``concat``, ``sum``, ``mul`` or ``ave``. Their
    weights nest under ``forward`` and ``backward``, the JAX tree's keys
    (registered into ``_modules`` directly: ``nn.Module`` keeps the name
    ``forward`` for its method)."""

    def __init__(self, layer: _RecurrentBase, merge_mode: str = "concat",
                 **kwargs):
        super().__init__(**kwargs)
        if merge_mode not in _MERGE:
            raise ValueError(f"unknown merge_mode {merge_mode!r}")
        backward = copy.deepcopy(layer)
        backward._auto_name = False
        backward.name = layer.name + "_bwd"
        backward.go_backwards = not layer.go_backwards
        self._modules["forward"] = layer
        self._modules["backward"] = backward
        self.merge_mode = merge_mode

    @property
    def fwd(self) -> _RecurrentBase:
        return self._modules["forward"]

    @property
    def bwd(self) -> _RecurrentBase:
        return self._modules["backward"]

    def build(self, input_shape, *, generator):
        self.fwd.build(input_shape, generator=generator)
        self.bwd.build(input_shape, generator=generator)

    def compute_output_shape(self, input_shape):
        shape = self.fwd.compute_output_shape(input_shape)
        if self.merge_mode == "concat":
            return tuple(shape[:-1]) + (2 * shape[-1],)
        return shape

    def call(self, x, *, training=False, generator=None):
        yf = self.fwd(x, training=training, generator=generator)
        yb = self.bwd(x, training=training, generator=generator)
        return _MERGE[self.merge_mode](yf, yb)
