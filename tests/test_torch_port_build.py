"""The port's CUDA build: a library is named by a hash of its sources, the
headers they include and the flags, so an edited header never reuses a
stale build. Runs without nvcc (the compiler is faked where a command
line is checked)."""

import importlib
import shutil
import subprocess
import threading

import pytest

from analytics_zoo_tpu_torch.ops import cuda_build

# the modules, not the functions the package re-exports under their names
flash_attention = importlib.import_module(
    "analytics_zoo_tpu_torch.ops.pallas.flash_attention")
quantized = importlib.import_module(
    "analytics_zoo_tpu_torch.ops.pallas.quantized")
cross_entropy = importlib.import_module(
    "analytics_zoo_tpu_torch.ops.pallas.cross_entropy")

LIBRARIES = {"flash_attention_fwd": flash_attention.LIBRARY,
             "flash_attention_bwd": flash_attention.LIBRARY_BWD,
             "fused_cross_entropy": cross_entropy.LIBRARY,
             "quantized": quantized.LIBRARY,
             "conv_int8": quantized.LIBRARY_CONV}


def _copy(lib, tmp_path):
    """``lib`` over a copy of ``csrc/`` under ``tmp_path``."""
    src = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, src)
    return cuda_build.CudaLibrary(lib.name, [s.name for s in lib.sources],
                                  lambda _: None, src_dir=src), src


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_library_path_follows_the_shared_header(name, tmp_path):
    """K2, K3a/K3b, K5a, K6 and C8 include ``hopper.cuh``: editing a copy
    of it names a new library file, and the sources alone do not
    change."""
    lib, src = _copy(LIBRARIES[name], tmp_path)
    assert [h.name for h in cuda_build.included_headers(lib.sources, src)] \
        == ["hopper.cuh"]
    before = lib.path()
    assert before.name == LIBRARIES[name].path().name
    header = src / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert lib.path() != before
    assert lib.path().name.startswith(f"lib{name}-")


def test_library_path_ignores_headers_it_does_not_include(tmp_path):
    lib, src = _copy(LIBRARIES["quantized"], tmp_path)
    before = lib.path()
    (src / "unused.cuh").write_text("// not included by any source\n")
    assert lib.path() == before


def test_nested_includes_are_followed(tmp_path):
    (tmp_path / "a.cu").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("#pragma once\n")
    lib = cuda_build.CudaLibrary("nested", ["a.cu"], lambda _: None,
                                 src_dir=tmp_path)
    assert [h.name for h in cuda_build.included_headers(lib.sources,
                                                        tmp_path)] == \
        ["b.cuh", "c.cuh"]
    before = lib.path()
    (tmp_path / "c.cuh").write_text("#pragma once\n// edited\n")
    assert lib.path() != before


def test_nvcc_gets_the_include_directory_not_the_header(tmp_path,
                                                         monkeypatch):
    """The header reaches nvcc through ``-I csrc/``; only the ``.cu``
    sources are compiled."""
    lib, src = _copy(LIBRARIES["flash_attention_fwd"], tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    seen = []

    def fake_run(cmd, **kwargs):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "no compiler here")

    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        lib.build()
    (cmd,) = seen
    assert cmd[cmd.index("-I") + 1] == str(src)
    assert [a for a in cmd if a.endswith((".cu", ".cuh"))] == \
        [str(src / "flash_attention_fwd.cu")]


# --- the launch path: cached entry points, raw stream, device guard ---

class _FakeCDLL:
    """Stands in for a loaded library: every attribute is an entry point
    of its own, the same object each time it is read."""

    loads = 0

    def __init__(self, path):
        type(self).loads += 1
        self.path = path

    def __getattr__(self, name):
        fn = object()
        setattr(self, name, fn)
        return fn


class _NoLock:
    def __enter__(self):
        raise AssertionError("the library's lock was taken")

    def __exit__(self, *exc):
        return False


def _fake_library(monkeypatch, tmp_path):
    """A ``CudaLibrary`` whose build and load are faked (no nvcc here)."""
    monkeypatch.setattr(cuda_build.CudaLibrary, "build",
                        lambda self: tmp_path / "libfake.so")
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", _FakeCDLL)
    _FakeCDLL.loads = 0
    bound = []
    return cuda_build.CudaLibrary("fake", ["fake.cu"], bound.append,
                                  src_dir=tmp_path), bound


def test_entry_point_is_cached_and_read_without_the_lock(monkeypatch,
                                                        tmp_path):
    lib, bound = _fake_library(monkeypatch, tmp_path)
    first = lib.entry("embed_expand")
    assert _FakeCDLL.loads == 1 and len(bound) == 1
    lib._lock = _NoLock()          # a second lookup must not touch it
    assert lib.entry("embed_expand") is first
    assert lib.get() is bound[0]
    other = lib.entry("dedup_scatter_add")
    assert other is not first and lib.entry("dedup_scatter_add") is other
    assert _FakeCDLL.loads == 1


def test_library_loads_once_under_concurrent_first_lookups(monkeypatch,
                                                          tmp_path):
    import threading
    lib, bound = _fake_library(monkeypatch, tmp_path)
    start = threading.Barrier(8)
    got = []

    def look():
        start.wait()
        got.append(lib.entry("int8_matmul"))
    threads = [threading.Thread(target=look) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _FakeCDLL.loads == 1 and len(bound) == 1
    assert len(got) == 8 and all(fn is got[0] for fn in got)


class _OnDevice:
    """A tensor stand-in: ``launch`` reads only its device index."""

    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


def test_launch_passes_the_raw_stream_and_switches_device_only_if_needed(
        monkeypatch):
    import torch
    switched = []

    class Switch:
        def __init__(self, index):
            switched.append(index)

        def __enter__(self):
            return None

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.cuda, "device", Switch)
    monkeypatch.setattr(cuda_build, "current_raw_stream",
                        lambda index: 0xA000 + index)
    made = []
    monkeypatch.setattr(cuda_build, "_THREAD", threading.local())
    monkeypatch.setattr(cuda_build, "make_current", made.append)
    calls = []

    def entry(*args):
        calls.append(args)
        return 7
    monkeypatch.setattr(cuda_build, "current_device", lambda: 1)
    assert cuda_build.launch(entry, _OnDevice(1), 5, None, 6) == 7
    assert calls == [(5, None, 6, 0xA001)] and switched == []
    monkeypatch.setattr(cuda_build, "current_device", lambda: 0)
    assert cuda_build.launch(entry, _OnDevice(1), 8) == 7
    assert calls[-1] == (8, 0xA001) and switched == [1]
    # the thread's first launch made the device's context current, once
    assert made == [1]


def test_launch_makes_the_context_current_once_per_new_thread(monkeypatch):
    """Fault m's guard: every thread's first launch makes the tensor's
    device current before the entry point runs, and that thread's later
    launches do not again; under 8 threads each does so once, for
    itself."""
    made = []
    order = []
    monkeypatch.setattr(cuda_build, "_THREAD", threading.local())
    monkeypatch.setattr(cuda_build, "make_current", lambda index: (
        made.append((threading.get_ident(), index)),
        order.append(("make", threading.get_ident()))))
    monkeypatch.setattr(cuda_build, "current_device", lambda: 0)
    monkeypatch.setattr(cuda_build, "current_raw_stream", lambda index: 0)

    def entry(*args):
        order.append(("entry", threading.get_ident()))
        return 0
    start = threading.Barrier(8)
    idents = []

    def work():
        idents.append(threading.get_ident())
        start.wait()
        for _ in range(3):
            assert cuda_build.launch(entry, _OnDevice(0)) == 0
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(made) == sorted((i, 0) for i in idents)
    for ident in idents:
        mine = [kind for kind, who in order if who == ident]
        assert mine == ["make"] + ["entry"] * 3
    assert len(order) == 8 * 4


def test_cpu_tensors_never_reach_the_stream_or_the_device_guard(
        monkeypatch):
    """Every kernel wrapper runs its plain version for CPU tensors before
    any launch machinery: the raw-stream helper, the device guard and the
    libraries are never touched."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas import cross_entropy, embedding

    def refuse(*args, **kwargs):
        raise AssertionError("launch machinery reached for a CPU tensor")
    monkeypatch.setattr(cuda_build, "current_raw_stream", refuse)
    monkeypatch.setattr(cuda_build, "current_device", refuse)
    monkeypatch.setattr(cuda_build, "make_current", refuse)
    monkeypatch.setattr(torch.cuda, "device", refuse)
    monkeypatch.setattr(quantized, "_plan", refuse)
    monkeypatch.setattr(cuda_build.CudaLibrary, "entry", refuse)
    monkeypatch.setattr(cuda_build.CudaLibrary, "get", refuse)
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(6, 4, generator=g)
    inv = torch.tensor([0, 5, 2, 5], dtype=torch.int32)
    embedding.embed_expand(rows, inv)
    embedding.dedup_scatter_add(torch.randn(4, 4, generator=g), inv, 6)
    key, order = torch.sort(inv.long(), stable=True)
    embedding.dedup_scatter_add(torch.randn(4, 4, generator=g), inv, 6,
                                order=order, sorted_slot=key)
    w = torch.randint(-127, 128, (16, 5), generator=g, dtype=torch.int8)
    s = torch.rand(5, generator=g) + 0.01
    for m in (3, 40):              # the skinny route's rows and the others'
        quantized.int8_matmul(torch.randn(m, 16, generator=g), w, s, True,
                              bias=torch.randn(5, generator=g), relu=True)
    q, k, v, do = (torch.randn(1, 2, 8, 32, generator=g) for _ in range(4))
    out, lse = flash_attention.flash_attention(q, k, v, want_lse=True)
    delta = (do * out).sum(-1)
    flash_attention.bwd_dq(q, k, v, None, lse, delta, do)
    flash_attention.bwd_dkv(q, k, v, None, lse, delta, do)
    h = torch.randn(5, 16, generator=g)
    wh = torch.randn(16, 12, generator=g)
    labels = torch.tensor([0, 3, 11, -1, 4], dtype=torch.int32)
    lse_ce, _ = cross_entropy.fused_ce_forward(h, wh, None, labels)
    scale = torch.ones(5)
    cross_entropy.fused_ce_backward_dh(h, wh, None, labels, lse_ce, scale)
    cross_entropy.fused_ce_backward_dw(h, wh, None, labels, lse_ce, scale)


def test_int8_plan_is_the_c_sides_and_asked_once_a_shape(monkeypatch):
    """K6's skinny route takes its K slicing and workspace size from the C
    side (``int8_matmul_plan``), asked once per shape and device; a device
    it cannot read raises."""
    import ctypes
    asked = []

    def plan(m, k, n, code, index, floats):
        asked.append((m, k, n, code, index))
        if index == 3:
            return -1
        ctypes.cast(floats, ctypes.POINTER(ctypes.c_longlong))[0] = \
            16 * m if m <= 32 else 0
        return int(m <= 32)
    monkeypatch.setattr(quantized.LIBRARY, "entry",
                        lambda name: {"int8_matmul_plan": plan}[name])
    quantized._plan.cache_clear()
    try:
        assert quantized._plan(8, 4096, 4096, 0, 0) == (True, 128)
        assert quantized._plan(8, 4096, 4096, 0, 0) == (True, 128)
        assert quantized._plan(64, 4096, 4096, 1, 0) == (False, 0)
        assert asked == [(8, 4096, 4096, 0, 0), (64, 4096, 4096, 1, 0)]
        with pytest.raises(RuntimeError, match="device 3"):
            quantized._plan(8, 64, 64, 0, 3)
    finally:
        quantized._plan.cache_clear()


def _ce_routes():
    """Every CE counter: each kernel's total and by-route launch counts and
    its latest route."""
    return ({name: c.launches for name, c in (
                ("fwd", cross_entropy.KERNEL_CE_FWD),
                ("dh", cross_entropy.KERNEL_CE_BWD_DH),
                ("dw", cross_entropy.KERNEL_CE_BWD_DW))},
            [{k: c.launches for k, c in routes.items()} for routes in (
                cross_entropy.KERNEL_CE_FWD_ROUTES,
                cross_entropy.KERNEL_CE_BWD_DH_ROUTES,
                cross_entropy.KERNEL_CE_BWD_DW_ROUTES)],
            [last.route for last in (cross_entropy.LAST_FWD_LAUNCH,
                                     cross_entropy.LAST_DH_LAUNCH,
                                     cross_entropy.LAST_DW_LAUNCH)])


@pytest.mark.parametrize("kernel", ["sa", "k4", "k5a", "k5b"])
def test_cpu_paths_of_sa_and_k5a_count_no_launch_and_report_no_route(kernel):
    """SA with the forward's sort, and K4, K5a and K5b on CPU tensors, run
    their plain versions: no launch is counted and the CE kernels' route
    reports (their counters by route, ``LAST_*_LAUNCH``) stay as they
    were."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas import embedding
    g = torch.Generator().manual_seed(1)
    if kernel == "sa":
        inv = torch.tensor([1, 0, 1], dtype=torch.int32)
        key, order = torch.sort(inv.long(), stable=True)
        sa = embedding.KERNEL_SCATTER_ADD.launches
        embedding.dedup_scatter_add(torch.randn(3, 2, generator=g), inv, 2,
                                    order=order, sorted_slot=key)
        assert embedding.KERNEL_SCATTER_ADD.launches == sa
        return
    h = torch.randn(5, 16, generator=g).bfloat16()
    w = torch.randn(16, 24, generator=g).bfloat16()
    labels = torch.tensor([0, 3, 23, -1, 4], dtype=torch.int32)
    lse, _ = cross_entropy.fused_ce_forward_reference(h, w, None, labels)
    before = _ce_routes()
    {"k4": lambda: cross_entropy.fused_ce_forward(h, w, None, labels),
     "k5a": lambda: cross_entropy.fused_ce_backward_dh(
         h, w, None, labels, lse, torch.ones(5)),
     "k5b": lambda: cross_entropy.fused_ce_backward_dw(
         h, w, None, labels, lse, torch.ones(5))}[kernel]()
    assert _ce_routes() == before


@pytest.mark.parametrize("kernel", ["fwd", "dh", "dw"])
@pytest.mark.parametrize("code,route", [(0, "wgmma"), (1, "mma"),
                                        (2, "fma")])
def test_ce_wrappers_pass_a_route_pointer_and_record_the_route(
        monkeypatch, kernel, code, route):
    """Each CE kernel's launch hands its C entry point a route pointer
    after its last argument and before the stream (as ``_bind`` declares
    it), and records the code the C side writes there: the launch counted
    in all and under that route, and ``LAST_*_LAUNCH`` set. The library
    and the launch are faked (no nvcc or card here); the operands are CPU
    tensors that ``launch`` never reads."""
    import ctypes

    import torch

    class Fn:
        argtypes = None
    lib = type("Lib", (), {})()
    for name in ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw"):
        setattr(lib, name, Fn())
    cross_entropy._bind(lib)
    entry = f"fused_ce_{kernel}" if kernel == "fwd" else \
        f"fused_ce_bwd_{kernel}"
    argtypes = getattr(lib, entry).argtypes
    assert argtypes[-2] == ctypes.POINTER(ctypes.c_int)
    assert argtypes[-1] == ctypes.c_void_p

    calls = []

    def fake_launch(fn, tensor, *args):
        assert fn == entry
        calls.append(args)
        args[-1]._obj.value = code   # the C side writes the route
        return 0
    monkeypatch.setattr(cross_entropy.LIBRARY, "entry", lambda name: name)
    monkeypatch.setattr(cross_entropy, "launch", fake_launch)
    g = torch.Generator().manual_seed(2)
    ops = cross_entropy._backward_operands(
        torch.randn(6, 64, generator=g).bfloat16(),
        torch.randn(64, 16, generator=g).bfloat16(),
        torch.randn(16, generator=g), torch.arange(6, dtype=torch.int32),
        torch.zeros(6), torch.ones(6))
    total, by_route, last = {
        "fwd": (cross_entropy.KERNEL_CE_FWD,
                cross_entropy.KERNEL_CE_FWD_ROUTES,
                cross_entropy.LAST_FWD_LAUNCH),
        "dh": (cross_entropy.KERNEL_CE_BWD_DH,
               cross_entropy.KERNEL_CE_BWD_DH_ROUTES,
               cross_entropy.LAST_DH_LAUNCH),
        "dw": (cross_entropy.KERNEL_CE_BWD_DW,
               cross_entropy.KERNEL_CE_BWD_DW_ROUTES,
               cross_entropy.LAST_DW_LAUNCH)}[kernel]
    counts = (total.launches, {k: c.launches for k, c in by_route.items()})
    prev = last.route
    try:
        {"fwd": lambda: cross_entropy._launch_fwd(*ops[:4]),
         "dh": lambda: cross_entropy._launch_dh(ops, torch.bfloat16, 64),
         "dw": lambda: cross_entropy._launch_dw(ops, True, 64)}[kernel]()
        (args,) = calls
        assert isinstance(args[-1], type(ctypes.byref(ctypes.c_int())))
        assert len(args) == len(argtypes) - 1   # the stream comes last
        assert total.launches == counts[0] + 1
        assert {k: c.launches for k, c in by_route.items()} == \
            {k: n + (k == route) for k, n in counts[1].items()}
        assert last.route == route
    finally:
        last.route = prev


@pytest.mark.parametrize("replays", [0, 1, 7])
def test_a_captured_steps_launches_count_at_every_replay(monkeypatch,
                                                         replays):
    """What a capture counted (here the CE forward's launch path with the
    library and the launch faked, twice, and K2's and K1's counters as
    their wrappers bump them) comes off the counters when the capture
    ends (nothing launched then) and is added back at every replay, by
    kernel and by route; counters the capture did not touch stay."""
    import torch

    from analytics_zoo_tpu_torch.ops import launch_count
    from analytics_zoo_tpu_torch.ops.pallas import embedding

    def fake_launch(fn, tensor, *args):
        args[-1]._obj.value = 0      # the C side reports wgmma
        return 0
    monkeypatch.setattr(cross_entropy.LIBRARY, "entry", lambda name: name)
    monkeypatch.setattr(cross_entropy, "launch", fake_launch)
    g = torch.Generator().manual_seed(3)
    ops = cross_entropy._backward_operands(
        torch.randn(4, 64, generator=g).bfloat16(),
        torch.randn(64, 16, generator=g).bfloat16(), None,
        torch.arange(4, dtype=torch.int32), torch.zeros(4), torch.ones(4))
    counters = {"k4": cross_entropy.KERNEL_CE_FWD,
                "k4_wgmma": cross_entropy.KERNEL_CE_FWD_ROUTES["wgmma"],
                "k4_fma": cross_entropy.KERNEL_CE_FWD_ROUTES["fma"],
                "k2": flash_attention.KERNEL,
                "k1": embedding.KERNEL_EMBED_EXPAND,
                "sa": embedding.KERNEL_SCATTER_ADD}
    assert all(c in launch_count.LaunchCount.ALL for c in counters.values())
    before = {k: c.launches for k, c in counters.items()}
    last = cross_entropy.LAST_FWD_LAUNCH.route
    try:
        with launch_count.record_launches() as record:
            for _ in range(2):
                cross_entropy._launch_fwd(*ops[:4])
            flash_attention.KERNEL.launches += 4
            embedding.KERNEL_EMBED_EXPAND.launches += 1
        assert {k: c.launches for k, c in counters.items()} == before
        for _ in range(replays):
            record.replayed()
        per = {"k4": 2, "k4_wgmma": 2, "k4_fma": 0, "k2": 4, "k1": 1,
               "sa": 0}
        assert {k: record.of(c) for k, c in counters.items()} == per
        assert {k: c.launches for k, c in counters.items()} == \
            {k: before[k] + replays * per[k] for k in counters}
    finally:
        for k, c in counters.items():
            c.launches = before[k]
        cross_entropy.LAST_FWD_LAUNCH.route = last


def test_a_failed_capture_leaves_the_counters_as_they_were():
    from analytics_zoo_tpu_torch.ops import launch_count
    before = flash_attention.KERNEL_BWD_DQ.launches
    with pytest.raises(RuntimeError, match="not capturable"):
        with launch_count.record_launches():
            flash_attention.KERNEL_BWD_DQ.launches += 3
            raise RuntimeError("not capturable")
    assert flash_attention.KERNEL_BWD_DQ.launches == before


# --------------------------------------------------------------------------
# the CUDA-graph kernel-node reader (ops/graph_kernels.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("raw,want", [
    ("void (anonymous namespace)::ce_fwd_wgmma<256>(float const*, int)",
     "ce_fwd_wgmma<256>"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, at::detail::Array<char*, 1> >(int, "
     "at::native::FillFunctor<float>, at::detail::Array<char*, 1>)",
     "vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "at::detail::Arr"),                  # cut to 80 characters
    ("segment_sum_sorted", "segment_sum_sorted"),
    ("void cub::DeviceRadixSortOnesweepKernel<Policy>(int*)",
     "DeviceRadixSortOnesweepKernel<Policy>"),
])
def test_kernel_name_drops_return_type_namespaces_and_arguments(raw, want):
    from analytics_zoo_tpu_torch.ops.graph_kernels import kernel_name
    assert kernel_name(raw) == want


def test_kernel_events_leave_out_copies_and_fills():
    from analytics_zoo_tpu_torch.ops.graph_kernels import is_kernel_event
    assert is_kernel_event("segment_sum_sorted")
    assert not is_kernel_event("Memcpy HtoD (Pageable -> Device)")
    assert not is_kernel_event("Memset (Device)")


def test_demangle_through_cxxfilt_and_unchanged_without_it(monkeypatch):
    from analytics_zoo_tpu_torch.ops import graph_kernels
    names = ["_ZN12_GLOBAL__N_118segment_sum_sortedEPKfi", "plain_name"]
    if shutil.which("c++filt"):
        assert graph_kernels.demangle(names) == [
            "(anonymous namespace)::segment_sum_sorted(float const*, int)",
            "plain_name"]
    assert graph_kernels.demangle([]) == []
    monkeypatch.setattr(graph_kernels.shutil, "which", lambda tool: None)
    assert graph_kernels.demangle(names) == names


class _FakeDriver:
    """The driver calls :func:`graph_kernel_names` makes, on a graph of
    handles: ``graphs[g]`` lists ``(node, kind, payload)``: a kernel
    node's payload is ``("func" | "kern", name)``, a child graph node's
    the child's handle."""

    def __init__(self, graphs, fail=None):
        self.graphs, self.fail, self.calls = graphs, fail, []
        self.nodes = {node: (kind, payload) for entries in graphs.values()
                      for node, kind, payload in entries}
        self.names = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls.append(name)
            if name == self.fail:
                return 999
            getattr(self, "_" + name)(*args)
            return 0
        return call

    def _cuGraphGetNodes(self, graph, nodes, count):
        entries = self.graphs[graph.value]
        if nodes is not None:
            for i, (node, _, _) in enumerate(entries):
                nodes[i] = node
        count._obj.value = len(entries)

    def _cuGraphNodeGetType(self, node, kind):
        kind._obj.value = self.nodes[node.value][0]

    def _cuGraphChildGraphNodeGetGraph(self, node, child):
        child._obj.value = self.nodes[node.value][1]

    def _cuGraphKernelNodeGetParams_v2(self, node, params):
        how, name = self.nodes[node.value][1]
        handle = 1000 + node.value
        self.names[handle] = name.encode()
        if how == "func":
            params._obj.func = handle
        else:
            params._obj.func, params._obj.kern = 0, handle

    def _cuFuncGetName(self, name, func):
        name._obj.value = self.names[func.value]

    def _cuKernelGetName(self, name, kern):
        name._obj.value = self.names[kern.value]


def test_graph_kernel_names_walks_child_graphs_in_node_order(monkeypatch):
    """Kernel nodes in the driver's order, a child graph's kernels in its
    node's place, other node types (copies, fills, events) left out;
    names read with ``cuFuncGetName``, or ``cuKernelGetName`` where the
    node holds a library kernel; a driver error raises."""
    from analytics_zoo_tpu_torch.ops import graph_kernels as gk
    graphs = {7: [(1, gk.GRAPH_NODE_KERNEL, ("func", "_Z4sortv")),
                  (2, 1, None),                       # a memcpy node
                  (3, gk.GRAPH_NODE_GRAPH, 8),
                  (4, gk.GRAPH_NODE_KERNEL, ("kern", "segment_sum"))],
              8: [(5, gk.GRAPH_NODE_KERNEL, ("func", "child_a")),
                  (6, 2, None),                       # a memset node
                  (9, gk.GRAPH_NODE_KERNEL, ("kern", "child_b"))]}
    fake = _FakeDriver(graphs)
    monkeypatch.setattr(gk.ctypes, "CDLL", lambda path: fake)
    assert gk.graph_kernel_names(7) == ["_Z4sortv", "child_a", "child_b",
                                        "segment_sum"]
    assert "cuKernelGetName" in fake.calls and "cuFuncGetName" in fake.calls
    monkeypatch.setattr(gk.ctypes, "CDLL", lambda path: _FakeDriver(
        graphs, fail="cuGraphNodeGetType"))
    with pytest.raises(RuntimeError, match="cuGraphNodeGetType"):
        gk.graph_kernel_names(7)


def test_chip_smoke_reads_kernels_through_the_port_module():
    import chip_smoke
    from analytics_zoo_tpu_torch.ops import graph_kernels
    for name in ("device_kernels", "graph_kernel_names", "demangle",
                 "kernel_name", "is_kernel_event"):
        assert getattr(chip_smoke, name) is getattr(graph_kernels, name)
