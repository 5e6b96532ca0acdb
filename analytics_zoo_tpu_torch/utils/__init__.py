"""Shared host-side helpers — port of ``analytics_zoo_tpu/utils``: the
prediction decode rule (``prediction.py``), durable checkpoints
(``checkpoint.py``) and their operator CLI (``ckpt_cli.py``), the
TensorBoard event files (``tensorboard.py``), the protobuf wire codec
(``proto.py``), TF tensor bundles (``tensor_bundle.py``) and profiling
(``profiling.py``). Nothing imported here at the top pulls in torch."""


def human_bytes(n: float) -> str:
    """``1536 -> "1.5KiB"`` — the operator CLIs' shared size formatter."""
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
