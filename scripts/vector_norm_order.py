"""Which summation order ``torch.linalg.vector_norm`` uses on the card for
a short f32 vector — the order G2 (``csrc/guard.cu``) must follow to give
its bits from the per-tensor norms.

For each length 1..128 it draws vectors of non-negative values (norms, at
several scales), takes ``vector_norm`` on the GPU, and replays candidate
orders on the CPU in exactly rounded f32 steps: each thread ``t`` of a
block of ``B`` threads (``last_pow2(n)``, 32 or 512) squares its
elements ``t, t + B, ...`` (into separate accumulators added after, each
square rounded before its add or fused with it), then the lanes are
combined by a tree whose offsets run up (1, 2, 4, ...) or down (B/2, ...,
1). It prints, for each candidate, the
lengths where it disagrees with the card, and the layout of
``torch._foreach_norm``'s outputs (whether they are views of one
buffer).

Run on a machine with a CUDA device:
``python3 scripts/vector_norm_order.py [--trials 40]``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _f32(x):
    return np.float32(x)


def _fma(a, b, c):
    # one rounding: the exact product and sum in float64, rounded once
    # (exact for these magnitudes but for rare double-rounding ties)
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _thread_sums(x, n, T, fused):
    """Each of ``T`` threads' sum of squares as ATen's ``thread_reduce``
    takes it: elements ``t, t + T, ...`` into four accumulators (a main
    loop while four strides fit, then a tail), added in order."""
    def red(acc, d):
        return _fma(d, d, acc) if fused else _f32(acc + _f32(d * d))
    out = []
    for t in range(T):
        acc = [_f32(0.0)] * 4
        idx = t
        while idx + 3 * T < n:
            for i in range(4):
                acc[i] = red(acc[i], x[idx + i * T])
            idx += 4 * T
        for i in range(4):
            if idx >= n:
                break
            acc[i] = red(acc[i], x[idx])
            idx += T
        v = acc[0]
        for i in range(1, 4):
            v = _f32(v + acc[i])
        out.append(v)
    return out


def _tree(vals, up, shared_first):
    """Lane 0's value after the block's combine: a shared-memory halving
    tree down to 32 lanes first (``shared_first``), then the warp's
    shuffle-down tree at rising (``up``) or falling offsets."""
    vals = list(vals)
    w = len(vals)
    if shared_first:
        off = w // 2
        while off >= 32:
            for t in range(off):
                vals[t] = _f32(vals[t] + vals[t + off])
            off //= 2
        w = min(w, 32)
        vals = vals[:w]
    offs = []
    off = 1
    while off < w:
        offs.append(off)
        off *= 2
    if not up:
        offs = offs[::-1]
    for off in offs:
        nxt = list(vals)
        for t in range(w):
            if t + off < w:
                nxt[t] = _f32(vals[t] + vals[t + off])
        vals = nxt
    return vals[0]


def _threads(n, rule):
    p = 1
    while p * 2 <= n:
        p *= 2
    return {"pow2": min(p, 512), "warp": 32, "block512": 512}[rule]


CANDIDATES = {
    f"{rule} threads, {'fma' if fused else 'two-adds'}, warp offsets "
    f"{'up' if up else 'down'}": (rule, fused, up)
    for rule in ("pow2", "warp", "block512") for fused in (False, True)
    for up in (True, False)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    grads = [torch.randn(7 + i, device="cuda") for i in range(12)]
    norms = torch._foreach_norm(grads)
    ptrs = [t.data_ptr() for t in norms]
    print("foreach_norm outputs: address steps",
          [b - a for a, b in zip(ptrs, ptrs[1:])], "storages",
          len({t.untyped_storage().data_ptr() for t in norms}))
    rng = np.random.default_rng(0)
    wrong = {name: [] for name in CANDIDATES}
    for n in range(1, 129):
        for trial in range(args.trials):
            scale = 10.0 ** rng.uniform(-4, 4)
            x = (np.abs(rng.standard_normal(n)) * scale).astype(np.float32)
            want = torch.linalg.vector_norm(
                torch.from_numpy(x).cuda()).cpu().numpy()
            for name, (rule, fused, up) in CANDIDATES.items():
                if n in wrong[name]:
                    continue
                s = _tree(_thread_sums(x, n, _threads(n, rule), fused), up,
                          True)
                got = np.float32(np.sqrt(np.float64(s)))
                if got.view(np.int32) != want.view(np.int32):
                    wrong[name].append(n)
    for name, ns in wrong.items():
        print(f"{name}: disagrees at {len(ns)} lengths {ns[:40]}")
    print(json.dumps({k: v for k, v in wrong.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
