"""Hand-written CUDA kernels standing in for ``analytics_zoo_tpu/ops/
pallas`` (the module paths mirror the JAX package's)."""

from .cross_entropy import fused_ce_forward
from .embedding import embed_expand
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_reference,
                              flash_attention_reference)
from .quantized import int8_matmul, int8_matmul_reference

__all__ = ["embed_expand", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_reference",
           "fused_ce_forward",
           "int8_matmul", "int8_matmul_reference"]
