"""Runtime bring-up — port of ``analytics_zoo_tpu/common/context.py``.

Layered configuration (bundled defaults < yaml file < ``ZOO_TPU_*`` env <
explicit conf < kwargs), the root seed, the tri-state flag parser and the
dtype-policy ownership rule. The JAX package's mesh and multi-host
bring-up have no counterpart here yet: the port drives one device, named
explicitly by every entry point (:func:`resolve_device`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Mapping, Optional

import torch

log = logging.getLogger("analytics_zoo_tpu_torch")

#: Bundled defaults — the keys this port reads. The spellings and the
#: values they accept are the JAX package's, so one config file (or one
#: ``ZOO_TPU_*`` environment) drives both.
DEFAULT_CONF: Dict[str, Any] = {
    "zoo.seed": 0,
    "zoo.pallas.attention": "auto",  # auto (CUDA, T >= 2048) | true | false
    "zoo.pallas.cross_entropy": "auto",  # fused-CE kernels: auto (CUDA) | true | false
    "zoo.pallas.embed_gather": "auto",   # dedup'd-embedding expand kernel: auto (CUDA) | true | false
    "zoo.compute.dtype": "float32",  # float32 | bfloat16
    "zoo.log.level": "INFO",
    "zoo.train.scan_steps": 1,       # optimizer steps a dispatch (one CUDA graph replay)
    "zoo.train.device_cache": False,  # dataset resident on the device, batches gathered there
    "zoo.train.fuse_epochs": 1,      # epochs a block with no host read (device_cache only)
    "zoo.train.fused_ce": "auto",    # fused LM-head CE: auto (V >= 1024) | true | false
    "zoo.train.fused_ce_chunk": 512,  # rows per streamed logits tile
    "zoo.embed.sharded": "auto",     # row-partitioned lookup for plain Embedding: auto | true | false
    "zoo.embed.dedup": True,         # per-step unique-id dedup in the lookup
    "zoo.serving.dtype": "float32",  # precision of models the server wraps:
    #   float32 | bfloat16 | int8 (int8 = weight-only, fp32 on the wire)
}

_ENV_PREFIX = "ZOO_TPU_"

#: normalized ("zoo_pallas_attention") → canonical ("zoo.pallas.attention")
_CANONICAL = {k.lower().replace(".", "_"): k for k in DEFAULT_CONF}


def _canonical_key(raw: str) -> str:
    """Map an underscore-separated key (env var / kwarg) to its canonical
    dotted form; unknown keys fall back to dots-for-underscores."""
    norm = raw.lower().replace(".", "_")
    if not norm.startswith("zoo_"):
        norm = "zoo_" + norm
    if norm in _CANONICAL:
        return _CANONICAL[norm]
    return norm.replace("_", ".")


def _parse_scalar(v: str) -> Any:
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _env_overrides() -> Dict[str, Any]:
    """``ZOO_TPU_COMPUTE_DTYPE=bfloat16`` → ``{"zoo.compute.dtype": ...}``."""
    return {_canonical_key(k[len(_ENV_PREFIX):]): _parse_scalar(v)
            for k, v in os.environ.items() if k.startswith(_ENV_PREFIX)}


def _flatten(d: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _load_yaml(path: str) -> Dict[str, Any]:
    """Flat yaml loader: pyyaml when installed, else a minimal parser of
    ``key: value`` lines with one level of nesting."""
    try:
        import yaml  # type: ignore
    except ImportError:
        yaml = None
    if yaml is not None:
        with open(path) as f:
            return _flatten(yaml.safe_load(f) or {})
    out: Dict[str, Any] = {}
    prefix = ""
    with open(path) as f:
        for raw in f:
            line = raw.rstrip()
            if not line or line.lstrip().startswith("#"):
                continue
            indented = line.startswith((" ", "\t"))
            key, _, val = line.strip().partition(":")
            val = val.strip()
            if not val:
                prefix = key + "."
                continue
            out[(prefix if indented else "") + key] = _parse_scalar(val)
            if not indented:
                prefix = ""
    return out


_DTYPE_NAMES = {"float32": "float32", "fp32": "float32",
                "bfloat16": "bfloat16", "bf16": "bfloat16"}


def dtype_name(dtype: Any) -> str:
    """``"float32"``/``"bfloat16"`` from a string or ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = str(dtype)
    if name not in _DTYPE_NAMES:
        raise ValueError(f"zoo.compute.dtype must be float32|bfloat16, "
                         f"got {dtype!r}")
    return _DTYPE_NAMES[name]


@dataclasses.dataclass
class ZooContext:
    """Process-wide runtime handle: the merged configuration."""

    conf: Dict[str, Any]

    @property
    def seed(self) -> int:
        return int(self.conf["zoo.seed"])

    def generator(self) -> torch.Generator:
        """A fresh CPU generator seeded from ``zoo.seed``."""
        return torch.Generator().manual_seed(self.seed)

    def get(self, key: str, default: Any = None) -> Any:
        return self.conf.get(key, default)


_context: Optional[ZooContext] = None


def init_zoo_context(conf: Optional[Mapping[str, Any]] = None,
                     conf_path: Optional[str] = None,
                     **kwargs: Any) -> ZooContext:
    """Initialise (or fetch) the global context. Precedence, lowest to
    highest: defaults, yaml ``conf_path``, ``ZOO_TPU_*`` env, ``conf``,
    ``kwargs``. A second call without settings returns the existing
    context."""
    global _context
    if _context is not None and conf is None and conf_path is None \
            and not kwargs:
        return _context
    merged: Dict[str, Any] = dict(DEFAULT_CONF)
    explicit: set = set()
    for layer in (_load_yaml(conf_path) if conf_path else {},
                  _env_overrides(), dict(conf or {})):
        merged.update(layer)
        explicit.update(layer)
    for k, v in kwargs.items():
        ck = _canonical_key(k)
        merged[ck] = v
        explicit.add(ck)
    # validate before any global side effect
    merged["zoo.compute.dtype"] = dtype_name(
        merged.get("zoo.compute.dtype", "float32"))
    train_dispatch(merged)
    logging.basicConfig(level=merged.get("zoo.log.level", "INFO"))
    # ownership: an explicit zoo.compute.dtype makes the CONTEXT own the
    # policy; a re-init without one resets a context-owned policy; a
    # policy set directly through engine.set_policy is left alone
    from ..pipeline.api.keras import engine as _engine
    if "zoo.compute.dtype" in explicit or _engine.policy_owner() == "context":
        _engine._set_policy_from_context(merged["zoo.compute.dtype"])
    _context = ZooContext(conf=merged)
    return _context


def _flag(value: Any, key: str, spellings: str = "true|false") -> bool:
    """A boolean flag from its value or one of its accepted spellings."""
    if isinstance(value, str):
        low = value.strip().lower()
        if low in TRUE_FLAG_SPELLINGS:
            return True
        if low in FALSE_FLAG_SPELLINGS:
            return False
        raise ValueError(f"{key} must be {spellings}, got {value!r}")
    return bool(value)


def _count(value: Any, key: str) -> int:
    try:
        n = int(value)
    except (TypeError, ValueError):
        n = 0
    if n < 1 or n != float(value):
        raise ValueError(f"{key} must be an integer >= 1, got {value!r}")
    return n


def train_dispatch(conf: Optional[Mapping[str, Any]] = None):
    """``(scan_steps, device_cache, fuse_epochs)`` from ``conf`` (default:
    the context's), checked: ``scan_steps`` optimizer steps a dispatch,
    the dataset resident on the device, and ``fuse_epochs`` epochs a
    block without a host read, which act only on the device-cached path
    (as ``fit`` applies them; JAX ``training.py:1716-1723``)."""
    if conf is None:
        conf = get_zoo_context().conf
    return (_count(conf.get("zoo.train.scan_steps", 1),
                   "zoo.train.scan_steps"),
            _flag(conf.get("zoo.train.device_cache", False),
                  "zoo.train.device_cache"),
            _count(conf.get("zoo.train.fuse_epochs", 1),
                   "zoo.train.fuse_epochs"))


def get_zoo_context() -> ZooContext:
    """Fetch the context, initialising with defaults if needed."""
    return init_zoo_context()


#: accepted spellings for boolean flags, shared by every tri-state parser
TRUE_FLAG_SPELLINGS = ("1", "true", "yes", "on")
FALSE_FLAG_SPELLINGS = ("0", "false", "no", "off", "")


def tri_state_conf(key: str, default: str = "auto"):
    """Parse an ``auto|true|false`` flag to ``"auto"``, ``True`` or
    ``False``; the call site decides what ``auto`` means. Raises
    ``ValueError`` on an unrecognised spelling."""
    flag = get_zoo_context().get(key, default)
    if isinstance(flag, str) and flag.strip().lower() == "auto":
        return "auto"
    return _flag(flag, key, "auto|true|false")


def reset_zoo_context() -> None:
    """Tear down the global context and the policy it owns (tests)."""
    global _context
    _context = None
    from ..pipeline.api.keras import engine as _engine
    _engine._reset_policy()


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Without a CUDA device and without ``device="cpu"`` this
    raises; it never moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           f"device is available")
    return dev
