"""Runtime bring-up — port of ``analytics_zoo_tpu/common/context.py``.

Layered configuration (bundled defaults < yaml file < ``ZOO_TPU_*`` env <
explicit conf < kwargs), the root seed, the tri-state flag parser, the
dtype-policy ownership rule, and the multi-process bring-up: with
``zoo.distributed.coordinator`` set, :func:`init_zoo_context` joins this
process to a ``torch.distributed`` process group (rank
``zoo.distributed.process_id`` of ``zoo.distributed.num_processes``) and
lays the device mesh over the ranks from ``zoo.mesh.{data,model,seq,
expert,pipe}`` (``ZooContext.mesh``, ``parallel/mesh.py``). With no
coordinator and one process nothing changes: one device, named explicitly
by every entry point (:func:`resolve_device`).
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
    "zoo.mesh.data": -1,        # -1 = all remaining ranks
    "zoo.mesh.model": 1,
    "zoo.mesh.seq": 1,
    "zoo.mesh.expert": 1,
    "zoo.mesh.pipe": 1,
    "zoo.seed": 0,
    # multi-process bring-up: empty coordinator = one process
    "zoo.distributed.coordinator": "",   # "host:port" (tcp) or "file:///path"
    "zoo.distributed.num_processes": 1,
    "zoo.distributed.process_id": 0,
    "zoo.seq.mode": "ring",              # seq-parallel routing: ring | ulysses | auto
    "zoo.seq.strict": False,             # fail (not warn) when attention can't ride the seq mesh
    "zoo.train.zero_sharding": False,    # ZeRO-1: optimizer state sharded over data axis
    "zoo.train.seq_attention": "off",    # force seq-parallel attention in the step: off | ring | ulysses
    "zoo.train.pipe_stages": 0,          # >0: cut the homogeneous block run into GPipe stages
    "zoo.train.pipe_microbatch": 0,      # GPipe microbatches (0 = the pipe axis size)
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
    "zoo.train.remat": False,         # scan-body remat: false | true/dots | full
    # -- anomaly sentinels / self-healing training
    "zoo.train.sentinel": "off",         # off | warn | recover: on-device
    #   nan-loss / nan-grad / grad-norm-spike checks folded into the step
    "zoo.train.spike_factor": 10.0,      # grad-norm spike = factor x its EWMA
    "zoo.train.grad_clip": 0.0,          # >0: global-norm gradient clipping in
    #   the step builders (zoo_train_grad_clip_engaged_total)
    "zoo.train.max_skips_per_epoch": 8,  # recover mode: skips past this in one
    #   epoch escalate to rollback-to-last-good-checkpoint
    "zoo.train.max_rollbacks": 3,        # rollbacks per fit before the loop
    #   fails loudly with TrainingDiverged (RetryBudget-backed)
    "zoo.failure.retry_times": 5,        # ≅ bigdl.failure.retryTimes (Topology.scala:1172)
    "zoo.failure.retry_window_sec": 3600,
    "zoo.checkpoint.keep": 3,
    "zoo.checkpoint.on_sigterm": False,  # SIGTERM during fit → final sync snapshot + clean exit
    "zoo.checkpoint.sigterm_grace_s": 0.0,  # >0: cut a MID-EPOCH snapshot from the
    #   SIGTERM handler when the estimated time to the next step boundary
    #   exceeds this budget (preemption deadline shorter than a dispatch)
    "zoo.embed.sharded": "auto",     # row-partitioned lookup for plain Embedding: auto | true | false
    "zoo.embed.dedup": True,         # per-step unique-id dedup in the lookup
    "zoo.embed.hot_rows_budget_mb": 64,  # device budget for the oocore hot tier
    "zoo.embed.prefetch_depth": 2,   # staged plans ahead of the consuming step
    "zoo.serving.dtype": "float32",  # precision of models the server wraps:
    #   float32 | bfloat16 | int8 (int8 = weight-only, fp32 on the wire)
    "zoo.serving.shed_watermark": 0,  # stream depth above which each
    #   admission window's newest records are shed (0 = off)
    "zoo.serving.adaptive_batch": False,  # AIMD batch target from the
    #   publish backlog and each read's queue waits
    "zoo.serving.queue_wait_target_ms": 500,  # the AIMD's queue-wait target
    "zoo.serving.shape_buckets": "",  # dispatch buckets, "4,16,32"
    #   ("" = powers of two up to batch_size)
    "zoo.serving.lane_max_inflight": "",  # per-lane windows, "lane:n,..."
    "zoo.serving.lane_batch_size": "",  # per-lane batch ceilings, "lane:n,..."
    "zoo.serving.dlq_dir": "",       # non-empty: the on-disk dead-letter queue
    "zoo.serving.dlq_max_bytes": 64 << 20,  # its disk bound, oldest evicted
    "zoo.serving.consumer_group": "serving",  # stream consumer group
    #   ("" = consume-on-read)
    "zoo.serving.claim_idle_ms": 30000,  # pending entries idle past this are
    #   reclaimable by a surviving replica (crash-safe entry reclaim)
    "zoo.serving.max_deliveries": 5,  # deliveries (read + reclaims) past
    #   this dead-letter the entry instead of reclaiming it forever
    "zoo.serving.fleet_backpressure": False,  # InputQueue.enqueue consults
    #   the fleet registry and slows, then refuses, producers when every
    #   live replica reports itself saturated (FleetSaturatedError)
    "zoo.faults.enabled": False,     # gate for common.faults.activate (chaos tests)
    # -- telemetry plane -----------------------------------------------------
    "zoo.telemetry.sample_interval_s": 1.0,  # cadence of the registry and
    #   device-memory samplers
    "zoo.telemetry.retention_s": 900.0,  # per-series history window; ring
    #   capacity = retention / sample interval (bounded, oldest evicted)
    "zoo.telemetry.device_memory": True,  # poll torch.cuda's allocator into
    #   zoo_device_hbm_bytes and the /statusz device block (no-op off-GPU)
    # -- performance attribution: goodput ledger + profiler trigger ---------
    "zoo.goodput.enabled": True,  # per-replica GoodputLedger: attribute
    #   every wall-clock second to an exclusive category
    "zoo.profiler.dir": "",       # ProfilerTrigger trace-dir root
    #   ("" = ./zoo-profiles); captures land in capture-NNNN-<trigger>/
    "zoo.profiler.keep": 3,       # newest capture dirs retained
    "zoo.profiler.duration_s": 10.0,  # time bound per capture (daemon
    #   timer stops the trace); used when zoo.profiler.steps == 0
    "zoo.profiler.steps": 0,      # >0 bounds a capture by step()
    #   notifications from the hosting loop instead of wall time
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
    """Process-wide runtime handle: the merged configuration and, in a
    process group, the device mesh over its ranks."""

    conf: Dict[str, Any]
    mesh: Any = None    # parallel.mesh.Mesh once a process group is up

    @property
    def process_index(self) -> int:
        import torch.distributed as dist
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def process_count(self) -> int:
        import torch.distributed as dist
        return dist.get_world_size() if dist.is_initialized() else 1

    @property
    def seed(self) -> int:
        return int(self.conf["zoo.seed"])

    def generator(self) -> torch.Generator:
        """A fresh CPU generator seeded from ``zoo.seed``."""
        return torch.Generator().manual_seed(self.seed)

    def get(self, key: str, default: Any = None) -> Any:
        return self.conf.get(key, default)


_context: Optional[ZooContext] = None


def _backend(cards: int, local: Optional[int]):
    """``(backend, reason)`` for a rank on a host with ``cards`` cards,
    ``local`` ranks on that host (None when unknown): NCCL when each rank
    has its own card, gloo on the CPU and where this host's ranks
    outnumber its cards. Without the local count each rank is taken to
    have its own card (a job over several hosts)."""
    if cards == 0:
        return "gloo", "no CUDA device"
    if local is not None and local > cards:
        return "gloo", (f"{local} ranks on this host share its {cards} "
                        f"card(s)")
    return "nccl", "a card a rank"


def _maybe_init_distributed(conf: Mapping[str, Any]) -> None:
    """Joins the process group ``zoo.distributed.*`` names (JAX
    ``_maybe_init_distributed``): ``init_process_group`` at the
    coordinator (``host:port`` → ``tcp://host:port``, or a ``file://``
    store), with the world size and rank given. The backend
    (:func:`_backend`): NCCL when each rank has its own card, gloo on the
    CPU and where the ranks on this host (``LOCAL_WORLD_SIZE``, as
    ``torchrun`` sets it) outnumber its cards. On CUDA a rank's card is
    its local rank (``LOCAL_RANK``, else the rank) modulo the card count.
    A process group already up, or no coordinator, leaves things as
    they are."""
    import torch.distributed as dist
    coordinator = str(conf.get("zoo.distributed.coordinator") or "").strip()
    if not coordinator or dist.is_initialized():
        return
    world = int(conf.get("zoo.distributed.num_processes", 1))
    rank = int(conf.get("zoo.distributed.process_id", 0))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local = os.environ.get("LOCAL_WORLD_SIZE")
    backend, why = _backend(cards, int(local) if local else None)
    if cards:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % cards)
        if backend == "gloo":
            log.warning("process group on gloo although CUDA is present: "
                        "%s", why)
    url = (coordinator if "://" in coordinator
           else f"tcp://{coordinator}")
    log.info("joining the process group at %s: rank %d of %d (%s: %s)",
             url, rank, world, backend, why)
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank)


def _make_mesh(conf: Mapping[str, Any]):
    """The mesh ``zoo.mesh.*`` lays over the world's ranks, set as the
    global mesh (JAX ``init_zoo_context``'s ``create_mesh``)."""
    from ..parallel import mesh as mesh_lib
    mesh = mesh_lib.create_mesh(
        data=int(conf["zoo.mesh.data"]), model=int(conf["zoo.mesh.model"]),
        seq=int(conf["zoo.mesh.seq"]), expert=int(conf["zoo.mesh.expert"]),
        pipe=int(conf["zoo.mesh.pipe"]))
    mesh_lib.set_global_mesh(mesh)
    return mesh


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
    _maybe_init_distributed(merged)
    import torch.distributed as dist
    mesh = _make_mesh(merged) if dist.is_initialized() else None
    _context = ZooContext(conf=merged, mesh=mesh)
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
    """Tear down the global context, the policy it owns and the global
    mesh (tests); a process group stays up."""
    global _context
    _context = None
    from ..parallel import mesh as _mesh
    from ..pipeline.api.keras import engine as _engine
    _engine._reset_policy()
    _mesh.reset_global_mesh()


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
