"""Seq2seq — port of ``analytics_zoo_tpu/models/seq2seq/seq2seq.py``
(``models/seq2seq/Seq2seq.scala:50``, ``RNNEncoder``/``RNNDecoder`` and
``Bridge.scala:38`` of the reference).

* encoder: stacked ``LSTM``/``GRU`` over ``(B, Te, D_in)``, each layer's
  final carry kept (``(h, c)`` for LSTM);
* bridge: ``passthrough``, or one square ``W`` (``bridge/W``) over the
  concatenated carries, ``tanh`` after it for ``densenonlinear``, split
  back into each layer's carry;
* decoder: stacked cells of the same type over ``(B, Td, D_dec)``, layer
  ``i`` started from the bridged carry of encoder layer ``i`` (teacher
  forcing in training);
* generator: an optional ``Dense`` on every time step.

The weights nest under the JAX names (``<net>_enc<i>``, ``<net>_dec<i>``,
``bridge``, ``<net>_gen``). :meth:`Seq2seq.infer` is the JAX host loop:
one decoder step a call, each output fed back as the next input, a row
that has met ``stop_sign`` kept at its previous output.
"""

from __future__ import annotations

import types
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...pipeline.api.keras.engine import Layer, param_dtype
from ...pipeline.api.keras.layers import GRU, LSTM, Dense
from ..common.zoo_model import ZooModel, register_model


class _Bridge(Layer):
    """``Bridge.scala:38``: one ``(dim, dim)`` weight over the flattened
    states, drawn from a unit normal scaled by ``dim ** -0.5``."""

    def __init__(self, dim: int, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim

    def build(self, input_shape=None, *, generator):
        w = torch.empty(self.dim, self.dim).normal_(generator=generator)
        self.add_weight("W", (w * self.dim ** -0.5).to(param_dtype()))


class _Seq2seqNet(Layer):
    """The encoder, bridge, decoder and generator as one layer on
    ``[encoder_input, decoder_input]``."""

    def __init__(self, spec: "Seq2seq", **kwargs):
        super().__init__(**kwargs)
        # the configuration, not the model (a module attribute would make
        # the model a child of its own network)
        self.spec = spec = types.SimpleNamespace(**spec.get_config())
        cell_cls = LSTM if spec.rnn_type == "lstm" else GRU
        self.encoder_cells = [
            cell_cls(spec.hidden_size, return_sequences=True,
                     name=f"{self.name}_enc{i}")
            for i in range(spec.num_layers)]
        self.decoder_cells = [
            cell_cls(spec.hidden_size, return_sequences=True,
                     name=f"{self.name}_dec{i}")
            for i in range(spec.num_layers)]
        for cell in self.encoder_cells + self.decoder_cells:
            self.add_module(cell.name, cell)
        self._gen_name = None
        if spec.generator_dim:
            gen = Dense(spec.generator_dim,
                        activation=spec.generator_activation,
                        name=f"{self.name}_gen")
            self._gen_name = gen.name
            self.add_module(gen.name, gen)
        # states per layer: LSTM carries (h, c), GRU carries h
        self.state_num = 2 if spec.rnn_type == "lstm" else 1
        self.bridge = None
        if spec.bridge in ("dense", "densenonlinear"):
            self.bridge = _Bridge(
                spec.hidden_size * self.state_num * spec.num_layers,
                name="bridge")
        self.built = False

    @property
    def gen_layer(self) -> Optional[Dense]:
        return self._modules[self._gen_name] if self._gen_name else None

    @property
    def input_shape(self):
        s = self.spec
        return [(None, None, s.input_dim), (None, None, s.decoder_input_dim)]

    def build(self, input_shape=None, *, generator):
        s = self.spec
        enc_shape, dec_shape = input_shape or self.input_shape
        for cells, shape in ((self.encoder_cells, enc_shape),
                             (self.decoder_cells, dec_shape)):
            for cell in cells:
                cell.build(shape, generator=generator)
                shape = (shape[0], shape[1], s.hidden_size)
        if self.bridge is not None:
            self.bridge.build(generator=generator)
        if self.gen_layer is not None:
            self.gen_layer.build((None, None, s.hidden_size),
                                 generator=generator)

    def compute_output_shape(self, input_shape):
        dim = self.spec.generator_dim or self.spec.hidden_size
        return (input_shape[1][0], input_shape[1][1], dim)

    # ---- the pieces call() and infer() share -----------------------------
    def encode(self, enc_x: torch.Tensor) -> List:
        h, carries = enc_x, []
        for cell in self.encoder_cells:
            h, carry = cell.run(h)
            carries.append(carry)
        return carries

    def apply_bridge(self, carries: List) -> List:
        if self.bridge is None:
            return carries
        flat = torch.cat([part for carry in carries for part in (
            carry if isinstance(carry, tuple) else (carry,))], dim=-1)
        out = torch.matmul(flat, self.bridge.W.to(flat.dtype))
        if self.spec.bridge == "densenonlinear":
            out = torch.tanh(out)
        splits = torch.chunk(out, self.state_num * self.spec.num_layers,
                             dim=-1)
        n = self.state_num
        return [tuple(splits[i * n:(i + 1) * n]) if n == 2 else splits[i]
                for i in range(self.spec.num_layers)]

    def decode(self, dec_x: torch.Tensor, carries: List):
        h, new_carries = dec_x, []
        for cell, carry in zip(self.decoder_cells, carries):
            h, c = cell.run(h, carry0=carry)
            new_carries.append(c)
        if self.gen_layer is not None:
            h = self.gen_layer(h)
        return h, new_carries

    def call(self, x, *, training=False, generator=None):
        if not isinstance(x, (list, tuple)) or len(x) != 2:
            raise ValueError(f"{self.name}: Seq2seq expects "
                             f"[encoder_input, decoder_input]")
        enc_x, dec_x = x
        out, _ = self.decode(dec_x, self.apply_bridge(self.encode(enc_x)))
        return out


@register_model
class Seq2seq(ZooModel):
    """``Seq2seq(encoder, decoder, inputShape, outputShape, bridge,
    generator)``, configured by type; ``device`` is where the weights live
    (``cuda`` unless given)."""

    def __init__(self, rnn_type: str = "lstm", num_layers: int = 1,
                 hidden_size: int = 64, input_dim: int = 32,
                 decoder_input_dim: Optional[int] = None,
                 bridge: str = "passthrough",
                 generator_dim: Optional[int] = None,
                 generator_activation: Optional[str] = None,
                 name: Optional[str] = None, device=None):
        if rnn_type not in ("lstm", "gru"):
            raise ValueError(f"rnn_type must be lstm|gru, got {rnn_type!r}")
        if bridge not in ("passthrough", "dense", "densenonlinear"):
            raise ValueError(f"bridge must be passthrough|dense|"
                             f"densenonlinear, got {bridge!r}")
        self.rnn_type = rnn_type
        self.num_layers = int(num_layers)
        self.hidden_size = int(hidden_size)
        self.input_dim = int(input_dim)
        self.decoder_input_dim = int(decoder_input_dim
                                     if decoder_input_dim is not None
                                     else input_dim)
        self.bridge = bridge
        self.generator_dim = generator_dim
        self.generator_activation = generator_activation
        super().__init__(name=name, device=device)

    def build_model(self) -> _Seq2seqNet:
        return _Seq2seqNet(self, name=self.name + "_net")

    def infer(self, input, start_sign, max_seq_len: int = 30,
              stop_sign=None) -> np.ndarray:
        """Greedy generation (``Seq2seq.scala:112``): the start sign in,
        then each step's output fed back as the next decoder input, one
        decoder step a call; once a row's output is within ``atol`` 1e-4
        of ``stop_sign`` in every entry, that row keeps repeating it, and
        the loop ends when every row has stopped. The generator's (or the
        hidden) width must equal ``decoder_input_dim``."""
        if not self.built:
            raise RuntimeError("no weights; fit() or init_weights() first")
        net: _Seq2seqNet = self.model
        dev = self.device
        enc_x = torch.from_numpy(np.asarray(input, np.float32))
        if enc_x.dim() == 2:
            enc_x = enc_x[None]
        cur = torch.from_numpy(np.asarray(start_sign, np.float32))
        if cur.dim() == 1:
            cur = cur[None, None]       # (1, 1, D)
        elif cur.dim() == 2:
            cur = cur[:, None]
        stop = (np.asarray(stop_sign, np.float32)
                if stop_sign is not None else None)
        done = np.zeros(enc_x.shape[0], bool)   # rows that have stopped
        frozen = None
        outs = []
        with torch.no_grad():
            carries = net.apply_bridge(net.encode(enc_x.to(dev)))
            cur = cur.to(dev)
            for _ in range(max_seq_len):
                y, carries = net.decode(cur, carries)
                step_out = y[:, 0].float().cpu().numpy()
                if frozen is not None:
                    step_out = np.where(done[:, None], frozen, step_out)
                outs.append(step_out)
                if stop is not None:
                    done |= np.isclose(step_out, stop, atol=1e-4).all(axis=-1)
                    frozen = step_out
                    if done.all():
                        break
                cur = torch.from_numpy(step_out[:, None]).to(dev)
        return np.stack(outs, axis=1)

    def get_config(self) -> Dict[str, Any]:
        return {"rnn_type": self.rnn_type, "num_layers": self.num_layers,
                "hidden_size": self.hidden_size, "input_dim": self.input_dim,
                "decoder_input_dim": self.decoder_input_dim,
                "bridge": self.bridge, "generator_dim": self.generator_dim,
                "generator_activation": self.generator_activation}
