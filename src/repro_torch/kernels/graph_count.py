"""What one call puts on the card, counted as the nodes of a captured CUDA
graph.

Exact where a torch.profiler window is not: on torch 2.11 a window lost
events of the kernels launched from this package's ctypes libraries (15 of
16 hash_probe calls seen, none of segment_reduce's device-carry entry).
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` count with it; a failed
CUDA driver call raises ``RuntimeError``.
"""
from __future__ import annotations

_CU_NODE_KERNEL, _CU_NODE_MEMCPY, _CU_NODE_MEMSET = 0, 1, 2  # CUgraphNodeType

ONE_KERNEL = {"kernels": 1, "memsets": 0, "copies": 0}


def graph_nodes(fn) -> dict:
    """The kernel, memset and copy nodes that one call of ``fn`` records in
    a CUDA graph, read from the captured graph through the CUDA driver
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``).  The call is captured,
    not run; the graph is freed at once."""
    import ctypes
    import torch
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUresult {rc}")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kinds = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        kinds.append(kind.value)
    graph.reset()
    return {"kernels": kinds.count(_CU_NODE_KERNEL),
            "memsets": kinds.count(_CU_NODE_MEMSET),
            "copies": kinds.count(_CU_NODE_MEMCPY)}


def launches_per_call(fn) -> dict:
    """CUDA kernels, memsets and copies that one call of ``fn`` puts on the
    card: the nodes of one captured call (``graph_nodes``), after a warm
    call off the capture."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return graph_nodes(fn)
