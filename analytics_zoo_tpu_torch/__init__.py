"""analytics_zoo_tpu_torch — the PyTorch/CUDA port of ``analytics_zoo_tpu``
for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax``, and
nothing of ``analytics_zoo_tpu``: the host code it needs (metrics registry,
retry/breaker, wire codec, queue backend) is carried as its own copy.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

Importing this package loads no kernel: CUDA sources under ``csrc/`` are
compiled with ``nvcc`` into ``build/`` at their first launch.
"""

__version__ = "0.1.0"

#: the JAX package's top-level re-exports, resolved on first use (PEP 562)
#: so that importing the package alone, as the host-only CLIs do, loads
#: no torch
_LAZY = {"init_zoo_context": "common.context",
         "get_zoo_context": "common.context"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
