"""Checkpoints: atomic per-step save/restore of a tree of tensors
(``ckpt``), readable by the JAX package's ``repro.checkpoint.ckpt``."""
