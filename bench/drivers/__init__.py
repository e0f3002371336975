"""Traffic drivers: ``run(ctx) -> dict``, one module each, named by a
workload file's ``driver`` key."""
