"""Deterministic synthetic token pipeline (``pipeline``)."""
