"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once; see ``bench/README.md``.  Nothing here imports JAX or
the JAX package: the system under test is ``repro_torch``, and the plain
references under ``bench/reference`` import nothing of it.
"""
