"""Port of the matching ``analytics_zoo_tpu`` package: the context, the
reliability primitives and the training triggers, re-exported under the
JAX package's names. They resolve on first use (PEP 562): ``context``
imports torch, and the host-only CLIs import ``common.reliability``
without it."""

_LAZY = {**dict.fromkeys(("ZooContext", "init_zoo_context",
                          "get_zoo_context", "reset_zoo_context"),
                         "context"),
         **dict.fromkeys(("CircuitBreaker", "CircuitOpenError",
                          "RetryPolicy"), "reliability"),
         **dict.fromkeys(("EveryEpoch", "SeveralIteration", "MaxEpoch",
                          "MaxIteration", "MinLoss", "TrainLoopState",
                          "Trigger"), "triggers")}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
