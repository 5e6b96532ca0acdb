"""Training noise on the device that uses it.

The JAX package folds the iteration into one base key per step and splits
that into a key per noise site. The port keeps that shape with
``torch.Generator``s seeded from ``(zoo.seed, iteration)``
(:func:`step_seed`):

* on the CPU the step's generator is a CPU generator, and layers split it
  into per-site CPU generators (seeds only, host integers);
* on a CUDA device the step's generator is a generator on that device,
  and every noise site of the step draws from it in program order. A
  step captured in a CUDA graph registers its generator with the graph,
  and the loop seeds it with the step's seed before every replay, so each
  replay draws new masks, the same ones the eager step draws at that
  iteration. Nothing is split on the host, and no mask crosses the bus.

A CPU generator handed to a model on a CUDA device (a direct call)
seeds a device generator for each draw. Torch's and JAX's streams never
agree; parity tests run with dropout 0.

Under ``zoo.train.remat`` the backward runs the step's forward again, and
that recompute must draw the forward's noise bit for bit, as JAX's
recompute does from the same key. :func:`stash` takes what the recompute
needs when the forward starts and :func:`redraw` puts it back around the
recompute: the generator's state (a host copy of its seed and offset) in
an eager step, or, in a step being captured in a CUDA graph, where a
generator's offset cannot be read, its *twin* (:func:`twins`): a
generator registered with the same graph and seeded as it is before
every replay, which the recompute draws from in its place
(``graphsafe_set_state``, which only swaps the generator's state for the
twin's). The twin has drawn nothing when the recompute starts, and the
forward started at its generator's seed, so both see the same offsets.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

#: the twins of the step generators of the capture in progress on this
#: thread (:func:`twins`), by the generator's id
_CAPTURE = threading.local()


def step_seed(seed: int, iteration: int) -> int:
    """The 63-bit seed of one training step's noise, from ``(seed,
    iteration)`` — the counterpart of ``fold_in(base_rng, iteration)``."""
    state = np.random.SeedSequence([seed, iteration]).generate_state(2)
    return (int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1)


def split_seeds(generator: torch.Generator, n: int):
    """``n`` seeds drawn from a CPU ``generator`` — host integers, so
    splitting never waits on a device."""
    if generator.device.type != "cpu":
        raise ValueError("seeds are split on a CPU generator; got one on "
                         f"{generator.device}")
    return torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()


def split_generators(generator: Optional[torch.Generator], n: int
                     ) -> List[Optional[torch.Generator]]:
    """One generator for each of ``n`` noise sites: independent CPU
    generators split from a CPU ``generator``; a device generator itself
    ``n`` times (its draws follow one another in program order); Nones
    for None."""
    if generator is None:
        return [None] * n
    if generator.device.type != "cpu":
        return [generator] * n
    return [torch.Generator().manual_seed(s)
            for s in split_seeds(generator, n)]


def noise_generator(generator: torch.Generator,
                    device: torch.device) -> torch.Generator:
    """The generator one draw on ``device`` uses: ``generator`` itself
    when it lies on that kind of device, else (a CPU generator and a CUDA
    tensor) a device generator seeded from it, so the noise is drawn
    where it is used and never crosses the bus."""
    device = torch.device(device)
    if generator.device.type == device.type:
        return generator
    if device.type == "cpu":
        raise ValueError(f"a generator on {generator.device} cannot draw "
                         f"CPU noise")
    return torch.Generator(device=device).manual_seed(
        split_seeds(generator, 1)[0])


@contextlib.contextmanager
def twins(pairs: Iterable[Tuple[torch.Generator, torch.Generator]]):
    """For the steps captured inside: each ``(generator, twin)`` pair
    names the generator a recompute draws ``generator``'s noise from
    (both registered with the graph and seeded alike before each
    replay)."""
    prev = getattr(_CAPTURE, "twins", None)
    _CAPTURE.twins = {id(g): (g, t) for g, t in pairs}
    try:
        yield
    finally:
        _CAPTURE.twins = prev


def stash(generator: Optional[torch.Generator]
          ) -> Union[None, torch.Tensor, torch.Generator]:
    """What a recompute needs to draw ``generator``'s noise again, taken
    where the forward starts: its state, or under capture its twin."""
    if generator is None:
        return None
    if (generator.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        pair = (getattr(_CAPTURE, "twins", None) or {}).get(id(generator))
        if pair is None or pair[0] is not generator:
            raise RuntimeError(
                "a rematerialised step captured in a CUDA graph draws its "
                "noise again from a twin of the step's generator, and this "
                "generator has none (common.noise.twins)")
        return pair[1]
    return generator.get_state()


@contextlib.contextmanager
def redraw(generator: Optional[torch.Generator],
           stashed: Union[None, torch.Tensor, torch.Generator]):
    """Runs a recompute that draws from ``generator`` the noise the
    forward drew after :func:`stash`; ``generator`` is left where the
    forward left it."""
    if generator is None:
        yield
        return
    if isinstance(stashed, torch.Generator):
        own = generator.graphsafe_get_state()
        generator.graphsafe_set_state(stashed)
        try:
            yield
        finally:
            generator.graphsafe_set_state(own)
        return
    after = generator.get_state()
    generator.set_state(stashed)
    try:
        yield
    finally:
        generator.set_state(after)
