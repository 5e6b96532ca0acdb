"""Sparse Mixture-of-Experts — port of ``analytics_zoo_tpu/pipeline/api/
keras/layers/moe.py``: token-choice top-k routing with capacity, the
experts stacked ``(E, d_in, d_h)``.

Routing is the JAX layer's, op for op (f32 softmax, top-k, renormalised
gates; positions by a cumulative sum that serves every token's first
choice before any second; tokens past an expert's capacity dropped; the
Switch load-balance loss and the optional router z-loss). On a device
mesh it runs over the global batch, as GSPMD runs the JAX layer: each
``data`` rank's router logits are gathered, so capacity, positions and the
load-balance statistics are the global batch's.

Expert parallelism (``param_sharding``: the stacked weights over
``expert``, their hidden dimension over ``model`` too): the tokens of a
``data`` rank are split over the ``expert`` ranks; each rank builds its
tokens' share of every expert's ``(C, d)`` slots, and the first
all-to-all hands each rank its experts' slots (each slot holds one token,
so the sum of the shares is exact); the rank runs its experts (the hidden
dimension split over ``model``, one all-reduce after the second
product); the second all-to-all hands every rank every expert's outputs,
from which it combines its tokens; the tokens are gathered again.

The auxiliary loss goes to the training step through
``engine.emit_aux_loss`` (the JAX ``aux_loss`` state key), which adds it
to the differentiated loss.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .....parallel import mesh as mesh_lib
from .....parallel.collectives import (all_to_all_grad, copy_to,
                                       gather_from, reduce_from, split_to)
from ..engine import (Layer, compute_dtype, emit_aux_loss, get_initializer,
                      param_dtype)
from .core import get_activation


class SparseMoE(Layer):
    """Token-choice top-k sparse MoE with expert capacity: each token's
    router picks ``top_k`` of ``num_experts`` experts; an expert serves at
    most ``capacity = ceil(top_k * n_tokens / num_experts) *
    capacity_factor`` tokens a batch, the rest contribute zero. Input
    ``(B, d)`` or ``(B, T, d)``, ``output_dim`` features out (default
    ``d``). The load-balance loss is ``E * dot(frac_tokens,
    mean_router_prob)`` times ``aux_loss_weight``, plus
    ``router_z_weight`` times ``mean(logsumexp(logits)^2)``."""

    def __init__(self, num_experts: int, hidden_dim: int,
                 output_dim: Optional[int] = None, top_k: int = 2,
                 capacity_factor: float = 1.25, activation="relu",
                 aux_loss_weight: float = 1e-2, router_z_weight: float = 0.0,
                 router_noise: float = 0.0, init: str = "glorot_uniform",
                 **kwargs):
        super().__init__(**kwargs)
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} not in [1, {num_experts}]")
        self.num_experts = num_experts
        self.hidden_dim = hidden_dim
        self.output_dim = output_dim
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.activation = get_activation(activation)
        self.aux_loss_weight = aux_loss_weight
        self.router_z_weight = router_z_weight
        self.router_noise = router_noise
        self.init = init

    def build(self, input_shape, *, generator):
        d = input_shape[-1]
        out = self.output_dim or d
        e, h = self.num_experts, self.hidden_dim
        init = get_initializer(self.init)
        self.add_weight("Wg", init(generator, (d, e), param_dtype()))
        self.add_weight("W1", init(generator, (e, d, h), param_dtype()))
        self.add_weight("b1", torch.zeros(e, h, dtype=param_dtype()))
        self.add_weight("W2", init(generator, (e, h, out), param_dtype()))
        self.add_weight("b2", torch.zeros(e, out, dtype=param_dtype()))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim
                                          or input_shape[-1],)

    def param_sharding(self, mesh=None):
        """The stacked experts over ``expert``, their hidden dimension over
        ``model`` too (EP x TP); the router whole."""
        e, m = mesh_lib.EXPERT_AXIS, mesh_lib.MODEL_AXIS
        return {"W1": (e, None, m), "b1": (e, m), "W2": (e, m, None),
                "b2": (e, None)}

    def _route(self, logits: torch.Tensor):
        """``(dispatch, combine, aux)`` of the JAX ``_route``: dispatch
        ``(N, E, C)`` the 0/1 token → (expert, slot) assignment, combine
        the dispatch weighted by the renormalised gates."""
        n, e = logits.shape
        k = self.top_k
        cap = min(max(1, int(-(-k * n // e) * self.capacity_factor)), n)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, idx = torch.topk(probs, k, dim=-1)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)
        mask = torch.nn.functional.one_hot(idx.long(), e).to(
            torch.float32).permute(1, 0, 2)                  # (k, N, E)
        flat = mask.reshape(k * n, e)
        pos_flat = torch.cumsum(flat, dim=0) - flat
        pos = (pos_flat.reshape(k, n, e) * mask).sum(-1).to(torch.int32)
        kept = mask * (pos_flat < cap).reshape(k, n, e).to(torch.float32)
        slot = (pos[..., None] == torch.arange(
            cap, device=logits.device)).to(torch.float32)    # (k, N, C)
        assign = kept[..., None] * slot[:, :, None, :]       # (k, N, E, C)
        dispatch = assign.sum(0)
        combine = (assign * gate_vals.T[..., None, None]).sum(0)
        aux = self.aux_loss_weight * e * torch.dot(mask[0].mean(0),
                                                   probs.mean(0))
        if self.router_z_weight:
            z = torch.logsumexp(logits, dim=-1)
            aux = aux + self.router_z_weight * torch.mean(z * z)
        return dispatch, combine, aux.to(torch.float32)

    def call(self, x, *, training=False, generator=None):
        cd = compute_dtype()
        lead, d = x.shape[:-1], x.shape[-1]
        tokens = x.reshape(-1, d)
        logits = torch.matmul(tokens.float(), self.Wg.float())
        if training and self.router_noise > 0.0:
            if generator is None:
                raise ValueError(f"{self.name}: router noise needs a "
                                 f"generator")
            from .....common.noise import noise_generator
            u = torch.rand(logits.shape, device=logits.device,
                           generator=noise_generator(generator,
                                                     logits.device))
            logits = logits * (1.0 - self.router_noise
                               + 2.0 * self.router_noise * u)
        mesh = getattr(self.W1, "_zoo_mesh", None)
        dp = None if mesh is None else mesh.group(mesh_lib.DATA_AXIS)
        # the router over the global batch: every data rank's logits
        dispatch, combine, aux = self._route(gather_from(logits, dp, 0))
        if dp is not None and dp.size > 1:
            rows = slice(dp.index * tokens.shape[0],
                         (dp.index + 1) * tokens.shape[0])
            dispatch, combine = dispatch[rows], combine[rows]
            # the data-parallel average of the gradients divides this
            # rank's share of the global loss's gradient by the axis: the
            # value stays, its gradient is taken dp times
            aux = aux * dp.size - aux.detach() * (dp.size - 1)
        if training:
            emit_aux_loss(aux)
        ep = mesh_lib.sharded_over(self.W1, mesh_lib.EXPERT_AXIS)
        tp = mesh_lib.sharded_over(self.W1, mesh_lib.MODEL_AXIS)
        # this expert rank's tokens, and their share of every expert's
        # slots
        x_e, d_e, c_e = (split_to(t, ep, 0)
                         for t in (tokens, dispatch, combine))
        xin = torch.einsum("nec,nd->ecd", d_e.to(cd), x_e.to(cd))
        if ep is not None:
            # first all-to-all: each rank its experts' slots
            xin = all_to_all_grad(xin, ep, 0, 0).reshape(
                ep.size, -1, *xin.shape[1:]).sum(0)
        xin = copy_to(xin, tp)
        h = torch.einsum("ecd,edh->ech", xin, self.W1.to(cd))
        h = self.activation(h + self.b1.to(cd)[:, None, :])
        out = reduce_from(torch.einsum("ech,eho->eco", h, self.W2.to(cd)),
                          tp)
        out = out + self.b2.to(cd)[:, None, :]
        if ep is not None:
            # second all-to-all: every rank every expert's outputs
            out = all_to_all_grad(out.repeat(ep.size, 1, 1), ep, 0, 0)
        y = torch.einsum("nec,eco->no", c_e.to(cd), out)
        y = gather_from(y, ep, 0)
        return y.reshape(*lead, y.shape[-1])
