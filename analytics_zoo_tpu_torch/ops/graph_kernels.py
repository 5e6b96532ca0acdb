"""The device kernels a call launches, read from a CUDA graph of it.

:func:`device_kernels` runs a call once on a side stream, captures a
second call into a CUDA graph and reads the graph's kernel nodes through
the driver API (:func:`graph_kernel_names`), each named without its
return type, namespaces and arguments (:func:`kernel_name`); copies and
fills are nodes of other types. ``torch.profiler`` read these before: on
the card its CUPTI records of such short captures lost their first
kernel in some runs and, in one run, came back empty three times in a
row. A graph holds every launch of the call.

Nothing here touches CUDA at import; the name handling
(:func:`kernel_name`, :func:`demangle`, :func:`is_kernel_event`) runs on
any host.
"""

from __future__ import annotations

import ctypes
import gc
import shutil
import subprocess
from typing import Callable, List, Sequence


def kernel_name(raw: str) -> str:
    """A device kernel's name without its return type, its namespaces and
    its argument list, its template arguments kept: ``void
    (anonymous namespace)::ce_fwd_wgmma<256>(float const*, ...)`` reads
    ``ce_fwd_wgmma<256>``, ``void at::native::vectorized_elementwise_
    kernel<4, ...>(...)`` reads ``vectorized_elementwise_kernel<4, ...>``
    (cut to 80 characters)."""
    s = raw.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    depth, end, start = 0, len(s), 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0 and ch == "(":
            end = i
            break
        elif depth == 0 and s.startswith("::", i):
            start = i + 2
    return s[start:end][:80]


def is_kernel_event(name: str) -> bool:
    """A profiler device record that is a kernel launch, not a copy or a
    fill."""
    return not name.startswith(("Memcpy", "Memset"))


class KernelNodeParams(ctypes.Structure):
    """The driver's ``CUDA_KERNEL_NODE_PARAMS_v2`` (``cuda.h``, CUDA 12)."""
    _fields_ = ([("func", ctypes.c_void_p)]
                + [(f, ctypes.c_uint) for f in (
                    "grid_x", "grid_y", "grid_z", "block_x", "block_y",
                    "block_z", "shared_bytes")]
                + [("kernel_params", ctypes.c_void_p),
                   ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                   ("ctx", ctypes.c_void_p)])


#: ``CUgraphNodeType``: a kernel, and a child graph
GRAPH_NODE_KERNEL, GRAPH_NODE_GRAPH = 0, 4


def graph_kernel_names(graph) -> List[str]:
    """The (mangled) names of the kernel nodes of a CUDA graph
    (``cudaGraph_t``, the driver's ``CUgraph``), child graphs' too, in the
    driver's node order, which for one stream's capture is the order of
    the launches. Read through the driver API (``cuFuncGetName`` and
    ``cuKernelGetName`` need a CUDA 12.3 driver)."""
    cu = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.c_void_p

    def call(name, *args):
        code = getattr(cu, name)(*args)
        if code:
            raise RuntimeError(f"CUDA driver error {code} in {name}")

    count = ctypes.c_size_t(0)
    call("cuGraphGetNodes", ptr(graph), None, ctypes.byref(count))
    nodes = (ptr * count.value)()
    call("cuGraphGetNodes", ptr(graph), nodes, ctypes.byref(count))
    names = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int()
        call("cuGraphNodeGetType", ptr(node), ctypes.byref(kind))
        if kind.value == GRAPH_NODE_GRAPH:
            child = ptr()
            call("cuGraphChildGraphNodeGetGraph", ptr(node),
                 ctypes.byref(child))
            names += graph_kernel_names(child.value)
        elif kind.value == GRAPH_NODE_KERNEL:
            params, name = KernelNodeParams(), ctypes.c_char_p()
            call("cuGraphKernelNodeGetParams_v2", ptr(node),
                 ctypes.byref(params))
            if params.func:
                call("cuFuncGetName", ctypes.byref(name), ptr(params.func))
            else:
                call("cuKernelGetName", ctypes.byref(name),
                     ptr(params.kern))
            names.append(name.value.decode())
    return names


def demangle(names: Sequence[str]) -> List[str]:
    """Itanium-mangled C++ names through ``c++filt`` (binutils, beside the
    host compiler that ``nvcc`` needs); unchanged where it is not on the
    path, which the callers' checks allow: they look for a kernel's own
    name inside the string."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def device_kernels(fn: Callable[[], object],
                   generators: Sequence[object] = ()) -> List[str]:
    """The names (:func:`kernel_name`) of the device kernels one call of
    ``fn`` launches: a warm-up call on a side stream, then one call
    captured into a CUDA graph, whose kernel nodes are read through the
    driver API. ``fn`` must be capturable (no host sync); the CUDA
    ``generators`` it draws from besides the default one are registered
    with the graph. A call that launches no kernel raises."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for gen in generators:
        graph.register_generator_state(gen)
    # no collection inside the capture: freeing a dead cycle's CUDA
    # resources there would invalidate it
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        if enabled:
            gc.enable()
    names = [kernel_name(n) for n in demangle(graph_kernel_names(
        graph.raw_cuda_graph()))]
    del graph
    if not names:
        raise RuntimeError("the captured call launched no device kernel")
    return names
