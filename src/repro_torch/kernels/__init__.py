"""Hand-written Hopper kernels with plain torch versions, and the entry
points that call them (``ops``).

Dataflow executor: stream_compact (filter, discard, barrier lowering),
segment_reduce (SLTF reduce) and hash_probe (the hash_table app's lookup,
through ``ops.hash_lookup``).  LM serving: flash_attention (prefill),
decode_attention, ssm_scan (the Mamba-1 selective scan), rg_lru (the RG-LRU
diagonal scan) and moe_dispatch (MoE dispatch into expert-capacity slots).
These eight are the counterparts of the reference's eight Pallas kernels.
Each builds its CUDA source from ``csrc/`` at first CUDA use (``_build``);
importing this package builds nothing.
"""
from . import ops  # noqa: F401
