"""repro_torch — Revet's dataflow-threads system on PyTorch and CUDA.

The same module layout as the JAX package ``repro`` (the reference): the
front end, compiler and executors are copies of its framework-neutral
modules, and the executor's lane-level hot loops run on a torch device
through :class:`repro_torch.core.backend.TorchBackend`, with hand-written
Hopper kernels for stream compaction and segmented reduction.  Users write
``from repro_torch import revet``.
"""
