#!/usr/bin/env python3
"""Holds the flash-attention backward kernels (K3a dq, K3b dk/dv) built from
this checkout against the same kernels built from another source tree,
bit for bit, on one NVIDIA GPU.

    python3 scripts/flash_bwd_same_bits.py OTHER_CSRC_DIR

``OTHER_CSRC_DIR`` holds another version's ``flash_attention_bwd.cu`` (and
the headers it includes), e.g. ``analytics_zoo_tpu_torch/csrc`` of an older
commit unpacked with ``git archive``. Both builds run on the same seeded
bf16 inputs at BERT's training shape (B=32, H=12, T=512, D=64, key padding)
and the LM's causal shape (B=16, H=8, T=4096, D=64). Prints one JSON line
per shape and exits non-zero when any of dq, dk, dv differs in a single bit
(or without a CUDA device).
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_bwd_same_bits: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import importlib

    from analytics_zoo_tpu_torch.ops import cuda_build
    # the module, not the function the package re-exports under its name
    fa = importlib.import_module(
        "analytics_zoo_tpu_torch.ops.pallas.flash_attention")

    other = cuda_build.CudaLibrary("flash_attention_bwd_other",
                                   ["flash_attention_bwd.cu"], fa._bind_bwd,
                                   src_dir=os.path.abspath(sys.argv[1]))
    cuda_build.build_all([fa.LIBRARY, fa.LIBRARY_BWD, other])
    ours = fa.LIBRARY_BWD

    def grads(lib, q, k, v, mask, lse, delta, do, causal):
        fa.LIBRARY_BWD = lib
        try:
            dq = fa.bwd_dq(q, k, v, mask, lse, delta, do, causal)
            return (dq, *fa.bwd_dkv(q, k, v, mask, lse, delta, do, causal))
        finally:
            fa.LIBRARY_BWD = ours

    ok = True
    g = torch.Generator().manual_seed(7)
    for name, (b, h, t, causal, padded) in {
            "bert_padded": (32, 12, 512, False, True),
            "lm_causal": (16, 8, 4096, True, False)}.items():
        q, k, v, do = (torch.randn(b, h, t, 64, generator=g).to(
            "cuda", torch.bfloat16) for _ in range(4))
        mask = None
        if padded:
            lens = torch.randint(64, t + 1, (b,), generator=g)
            mask = (torch.arange(t)[None, :] < lens[:, None]).float().cuda()
        out, lse = fa.flash_attention(q, k, v, mask=mask, causal=causal,
                                      want_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        mine = grads(ours, q, k, v, mask, lse, delta, do, causal)
        theirs = grads(other, q, k, v, mask, lse, delta, do, causal)
        torch.cuda.synchronize()
        same = {key: torch.equal(a.view(torch.int16), c.view(torch.int16))
                for key, a, c in zip(("dq", "dk", "dv"), mine, theirs)}
        ok = ok and all(same.values())
        print(json.dumps({"shape": name, "dims": [b, h, t, t, 64],
                          "causal": causal, "same_bits": same}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
