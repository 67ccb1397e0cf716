"""The model stack, ported to PyTorch: config schema, layers and the
transformer (dense family in this slice)."""
