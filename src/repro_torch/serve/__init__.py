"""Serving: request-batched dataflow launches (``dataflow.DataflowEngine``)."""
