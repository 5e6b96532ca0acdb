"""Training noise on the device that uses it.

The JAX package splits one ``jax.random`` key per step into a key per
noise site. The port keeps that shape with ``torch.Generator``s: the
training loop seeds one CPU generator per step, layers split it into
per-site CPU generators (seeds only, host integers, no device sync), and
each draw makes a generator on the tensor's own device from one more
seed. So a dropout mask is drawn where it is used and never crosses the
bus. Torch's and JAX's streams never agree; parity tests run with
dropout 0.
"""

from __future__ import annotations

import torch


def split_seeds(generator: torch.Generator, n: int):
    """``n`` seeds drawn from a CPU ``generator`` — host integers, so
    splitting never waits on a device."""
    if generator.device.type != "cpu":
        raise ValueError("training noise is split on a CPU generator; got "
                         f"one on {generator.device}")
    return torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()


def noise_generator(generator: torch.Generator,
                    device: torch.device) -> torch.Generator:
    """A generator on ``device`` for one noise draw: ``generator`` itself
    on the CPU, else a device generator seeded from it, so the noise is
    drawn where it is used and never crosses the bus."""
    device = torch.device(device)
    if device.type == "cpu":
        return generator
    return torch.Generator(device=device).manual_seed(
        split_seeds(generator, 1)[0])
