"""The model stack, ported to PyTorch: config schema, layers and the
transformer (dense and SSM families so far)."""
