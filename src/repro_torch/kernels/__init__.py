"""Hand-written Hopper kernels with plain torch versions, and the entry
points that call them (``ops``).

Dataflow executor: stream_compact (filter, discard, barrier lowering) and
segment_reduce (SLTF reduce).  LM serving: flash_attention (prefill),
decode_attention, ssm_scan (the Mamba-1 selective scan) and rg_lru (the
RG-LRU diagonal scan).  Each builds
its CUDA source from ``csrc/`` at first CUDA use (``_build``); importing
this package builds nothing.
"""
from . import ops  # noqa: F401
