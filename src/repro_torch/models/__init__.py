"""The LM stack of the port: parameter specs, layers, the dense, MoE, SSM
and hybrid families, and the model zoo."""
