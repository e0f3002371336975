"""The LM stack of the port: parameter specs, layers, the dense transformer
and the model zoo (dense family so far)."""
