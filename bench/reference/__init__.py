"""Plain float32 PyTorch references of the benchmark's model families.

They import nothing of the port and take nothing it made: the weights are
the benchmark's (``bench/model.py``), handed to both sides, and each
reference applies what the configuration file declares.  Callers turn
TF32 off (``measure.no_tf32``).
"""
