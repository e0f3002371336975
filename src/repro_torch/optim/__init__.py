"""Optimizer (``adamw``) and int8 gradient compression with error feedback
(``compression``) over trees of tensors."""
