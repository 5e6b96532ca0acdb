"""Hand-written CUDA kernels standing in for ``analytics_zoo_tpu/ops/
pallas`` (the module paths mirror the JAX package's)."""

from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_reference,
                              flash_attention_reference)
from .quantized import int8_matmul, int8_matmul_reference

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_reference",
           "int8_matmul", "int8_matmul_reference"]
