"""Hand-written Hopper kernels of the dataflow executor, with plain torch
versions, and the executor entry points that call them (``ops``).

stream_compact (filter, discard, barrier lowering) and segment_reduce (SLTF
reduce) each build their CUDA source from ``csrc/`` at first CUDA use
(``_build``); importing this package builds nothing.
"""
from . import ops  # noqa: F401
