"""Which summation orders ``torch.linalg.vector_norm`` and
``torch._foreach_norm`` use on the card for f32 — the orders G2
(``csrc/guard.cu``) follows to give their bits from the gradients.

``vector_norm``: for each length 1..300 it draws vectors of non-negative
values (norms, at several scales), takes ``vector_norm`` on the GPU, and
replays candidate orders on the CPU in exactly rounded f32 steps: each
thread ``t`` of a block of ``B`` threads (``last_pow2(n)``, 32 or 512)
squares its elements ``t, t + B, ...`` (into separate accumulators added
after, each square rounded before its add or fused with it), or, from a
length on (128 or 129), loads four floats a thread (``B =
last_pow2(n / 4)``, thread ``t`` takes float4 ``t, t + B, ...`` and the
tail); then the lanes are combined by a shared-memory halving tree down
to 32 and a warp tree whose offsets run up (1, 2, 4, ...) or down (B/2,
..., 1). It prints, for each candidate, the lengths where it disagrees
with the card, and the layout of ``torch._foreach_norm``'s outputs.

``_foreach_norm``: for tensors of assorted lengths (a few elements to
several 65,536-element chunks, lengths off a multiple of 4, misaligned
views), the per-tensor norm replayed as ATen's LpNormFunctor and
``lpnorm_cleanup`` take it (512-thread blocks, four accumulators a
thread on the vectorised or the strided path, BlockReduceSum, then the
cleanup block over the chunk partials), with the squares' additions
fused or not; it prints the tensors where each candidate disagrees.

Run on a machine with a CUDA device:
``python3 scripts/vector_norm_order.py [--trials 40] [--out FILE.json]``.
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


def _vec_sums(x, n, T, fused):
    """Each of ``T`` threads' sum of squares as ATen's
    ``input_vectorized_thread_reduce_impl`` takes it: float4 ``t, t + T,
    ...`` into four accumulators, then the tail's elements ``n - n % 4 +
    t`` into the first, the four added in order."""
    def red(acc, d):
        return _fma(d, d, acc) if fused else _f32(acc + _f32(d * d))
    out = []
    for t in range(T):
        acc = [_f32(0.0)] * 4
        v = t
        while 4 * v + 3 < n:
            for i in range(4):
                acc[i] = red(acc[i], x[4 * v + i])
            v += T
        tail = n - n % 4 + t
        if tail < n:
            acc[0] = red(acc[0], x[tail])
        s = acc[0]
        for i in range(1, 4):
            s = _f32(s + acc[i])
        out.append(s)
    return out


def _threads(n, rule):
    p = 1
    while p * 2 <= n:
        p *= 2
    return {"pow2": min(p, 512), "warp": 32, "block512": 512}[rule]


CANDIDATES = {
    f"{rule} threads, {'fma' if fused else 'two-adds'}, warp offsets "
    f"{'up' if up else 'down'}"
    f"{f', float4 from {vec}' if vec else ''}": (rule, fused, up, vec)
    for rule in ("pow2", "warp", "block512") for fused in (False, True)
    for up in (True, False) for vec in (None, 128, 129)
    if vec is None or rule == "pow2"}


def _vector_norm(x, n, rule, fused, up, vec):
    if vec is not None and n >= vec:
        T = min(_threads(n // 4, "pow2"), 512)
        s = _tree(_vec_sums(x, n, T, fused), up, True)
    else:
        s = _tree(_thread_sums(x, n, _threads(n, rule), fused), up, True)
    return np.float32(np.sqrt(np.float64(s)))


# ---------------------------------------------------------------------------
# _foreach_norm
# ---------------------------------------------------------------------------

CHUNK, BLOCK = 65536, 512


def _sq(acc, x, fused):
    if fused:
        return (x.astype(np.float64) * x + acc).astype(np.float32)
    return (acc + (x * x).astype(np.float32)).astype(np.float32)


def _warp_tree(v):
    """Lane 0 of each warp's shuffle-down tree (16, ..., 1) over the last
    axis cut into warps of 32."""
    v = v.reshape(-1, 32).copy()
    off = 16
    while off:
        v[:, :off] = (v[:, :off] + v[:, off:2 * off]).astype(np.float32)
        off //= 2
    return v[:, 0]


def _block_reduce(vals):
    """BlockReduceSum over 512 thread values: the warps' trees, then warp 0
    over the 16 warp sums (lanes 16-31 zero)."""
    w = np.zeros(32, np.float32)
    w[:16] = _warp_tree(vals)
    return _warp_tree(w)[0]


def _chunk_partial(c, aligned, fused):
    """LpNormFunctor's partial of one chunk ``c`` (f32, at most CHUNK)."""
    lim = len(c)
    t = np.arange(BLOCK)
    vals = np.zeros((BLOCK, 4), np.float32)
    if aligned:
        for k in range(CHUNK // (4 * BLOCK)):
            base = 4 * (t + BLOCK * k)
            live = base < lim
            if not live.any():
                break
            for i in range(4):
                x = np.where(live, c[np.minimum(base + i, lim - 1)], 0)
                vals[:, i] = np.where(live, _sq(vals[:, i], x, fused),
                                      vals[:, i])
    else:
        for k in range(-(-lim // (4 * BLOCK))):
            for i in range(4):
                e = 4 * BLOCK * k + t + BLOCK * i
                live = e < lim
                x = np.where(live, c[np.minimum(e, lim - 1)], 0)
                vals[:, i] = np.where(live, _sq(vals[:, i], x, fused),
                                      vals[:, i])
    v = vals[:, 0]
    for i in range(1, 4):
        v = (v + vals[:, i]).astype(np.float32)
    return _block_reduce(v)


def _foreach_norm(x, aligned, fused):
    """One tensor's norm as ``_foreach_norm`` takes it: the chunk partials,
    then ``lpnorm_cleanup`` (thread t sums partials t, t + 512, ...)."""
    parts = [_chunk_partial(x[s:s + CHUNK], aligned, fused)
             for s in range(0, len(x), CHUNK)] or [np.float32(0)]
    vals = np.zeros(BLOCK, np.float32)
    for i, p in enumerate(parts):
        vals[i % BLOCK] = np.float32(vals[i % BLOCK] + p)
    return np.float32(np.sqrt(np.float64(_block_reduce(vals))))


def foreach_order(rng):
    """The tensors where each candidate replay of ``_foreach_norm``
    disagrees with the card."""
    base = torch.randn(3 * CHUNK + 40, device="cuda")
    cases = [torch.randn(n, device="cuda") * 10.0 ** rng.uniform(-3, 3)
             for n in (1, 3, 4, 5, 8, 13, 4096, 4099, CHUNK, CHUNK + 4,
                       CHUNK + 1, 2 * CHUNK + 3, 3 * CHUNK + 8)]
    cases += [base[1:], base[2:2 + 4096], base[4:4 + CHUNK + 4],
              base[3:3 + 2 * CHUNK]]
    wrong = {f"{'fma' if fused else 'two-adds'}": [] for fused in
             (True, False)}
    got = torch._foreach_norm(cases)
    for i, (t, want) in enumerate(zip(cases, got)):
        x = t.cpu().numpy().astype(np.float32)
        aligned = t.data_ptr() % 16 == 0 and t.numel() % 4 == 0
        want = want.cpu().numpy().astype(np.float32)
        for fused in (True, False):
            mine = _foreach_norm(x, aligned, fused)
            if mine.view(np.int32) != want.view(np.int32):
                wrong["fma" if fused else "two-adds"].append(
                    (i, t.numel(), bool(aligned)))
    return wrong


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=40)
    ap.add_argument("--max-len", type=int, default=300)
    ap.add_argument("--out", default=None)
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
    for n in range(1, args.max_len + 1):
        for trial in range(args.trials):
            scale = 10.0 ** rng.uniform(-4, 4)
            x = (np.abs(rng.standard_normal(n)) * scale).astype(np.float32)
            want = torch.linalg.vector_norm(
                torch.from_numpy(x).cuda()).cpu().numpy()
            for name, cand in CANDIDATES.items():
                if n in wrong[name]:
                    continue
                got = _vector_norm(x, n, *cand)
                if got.view(np.int32) != want.view(np.int32):
                    wrong[name].append(n)
    for name, ns in wrong.items():
        print(f"vector_norm {name}: disagrees at {len(ns)} lengths "
              f"{ns[:40]}")
    foreach = foreach_order(rng)
    for name, bad in foreach.items():
        print(f"_foreach_norm {name}: disagrees on {len(bad)} tensors "
              f"{bad}")
    line = json.dumps({"vector_norm": wrong, "foreach_norm": foreach})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
