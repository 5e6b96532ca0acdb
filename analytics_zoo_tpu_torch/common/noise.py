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
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


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
