"""Fault tolerance: the checkpoint/restart supervisor, the serving launch
supervisor, straggler detection and cooperative preemption."""
