"""Networks of the port (``nn.Module`` counterparts of the flax models)."""
