#!/usr/bin/env python3
"""The sharded NCF path of the tree at TREE, on one GPU, for an A/B of two
trees in turns:

    python3 scripts/ncf_in_turns.py TREE NAME

Run it for both trees in one command (parent, change, change, parent; the
parent unpacked by ``git archive``), since the host's speed moves NCF
from machine to machine. TREE's own package and its ``chip_smoke.py``'s
``ncf_phase`` are run; the measuring helpers (``step_kernels``,
``device_kernels``, ``graph_ms``, ``time_ms``) are this checkout's, so
both trees are read the same way. Prints one line ``AB {json}``:

- both NCF configurations' records/s and ms a step (``ncf_phase``);
- the device kernels of one forward and one backward of the
  ``ShardedEmbedding`` graph at batch 8192, with the sorts and searches
  among the backward's;
- the dedup'd embedding's scatter-add (SA) called as TREE's lookup
  backward calls it (the call is recorded from one backward, then
  replayed), at the NCF user table's shape (8192 ids over 6041 rows,
  D = 20, f32) and a DLRM-Terabyte width (53,248 ids over a million rows,
  D = 128): its device kernels with their durations (``torch.profiler``),
  device ms (CUDA-graph replay) and wrapper ms, beside ``index_add_``'s.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _harness():
    """This checkout's ``chip_smoke.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location("harness",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sa_as_the_lookup_calls_it(se, emb, table, ids):
    """The SA call TREE's lookup backward makes for ``table[ids]``:
    ``(g, inv, capacity, kwargs)``, recorded from one backward."""
    import torch
    seen = []
    real = se.dedup_scatter_add

    def record(g, inv, capacity, **kw):
        seen.append((g, inv, capacity, kw))
        return real(g, inv, capacity, **kw)
    se.dedup_scatter_add = record
    try:
        t = table.detach().requires_grad_()
        out = se.dedup_embedding_lookup(t, ids, use_kernel=True)
        out.backward(torch.randn(out.shape, device=out.device))
    finally:
        se.dedup_scatter_add = real
    (call,) = seen
    return call


def sa_profile(h, se, emb):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(0)
    out = {}
    for case, v, d, n in (("ncf_user", 6041, 20, 8192),
                          ("dlrm_f32", 1_000_000, 128, 53248)):
        ids = torch.from_numpy(rng.integers(1, v, n).astype(np.int32)).cuda()
        table = torch.randn(v, d, device="cuda")
        g, inv, cap, kw = sa_as_the_lookup_calls_it(se, emb, table, ids)

        def call():
            return emb.dedup_scatter_add(g, inv, cap, **kw)
        for _ in range(2):  # the second trace is kept: the first of a
            # process may miss the device's events
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
        kernels = [(e.name[-60:], e.time_range.elapsed_us())
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        inv64, acc = inv.long(), torch.zeros(cap, d, device="cuda")
        out[case] = {
            "handed_sort": sorted(kw), "kernels": kernels,
            "device_ms": h.graph_ms(call), "wall_ms": h.time_ms(call,
                                                                iters=50),
            "index_add_device_ms": h.graph_ms(
                lambda: acc.index_add_(0, inv64, g)),
            "index_add_wall_ms": h.time_ms(
                lambda: acc.index_add_(0, inv64, g), iters=50)}
    return out


def main() -> int:
    root, name = os.path.abspath(sys.argv[1]), sys.argv[2]
    h = _harness()
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as c
    from analytics_zoo_tpu_torch.ops import sharded_embedding as se
    from analytics_zoo_tpu_torch.ops.pallas import embedding as emb
    from analytics_zoo_tpu_torch.pipeline.api.keras import objectives
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    if not torch.cuda.is_available():
        print("ncf_in_turns: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emb.LIBRARY.get()
    x, y = c.make_movielens_like(np.random.default_rng(0))
    out = c.ncf_phase(x, y)
    reset_uids()
    net = c.sharded_ncf(max(c.N_USERS, int(x[:, 0].max())),
                        max(c.N_ITEMS, int(x[:, 1].max())),
                        c.N_CLASSES).init_weights()
    loss_fn = objectives.get_loss("scce")
    xb = torch.from_numpy(x[:c.NCF_BATCH]).cuda()
    yb = torch.from_numpy(y[:c.NCF_BATCH]).cuda()
    h.step_kernels(net, xb, yb, loss_fn)  # the second pass is the one kept
    fwd, bwd = h.step_kernels(net, xb, yb, loss_fn)
    print("AB " + json.dumps({
        "tree": name, "stock": out["stock"]["recs_per_s"],
        "sharded": out["sharded"]["recs_per_s"],
        "stock_ms_step": out["stock"]["ms_per_step"],
        "sharded_ms_step": out["sharded"]["ms_per_step"],
        "fwd_kernels": len(fwd), "bwd_kernels": len(bwd),
        "bwd_sort_or_search": sum("radix" in k.lower()
                                  or "searchsorted" in k.lower()
                                  for k in bwd),
        "sa": sa_profile(h, se, emb)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
