"""Operators of the PyTorch port: plain tensor code and the wrappers of
the hand-written kernels (B1-B11)."""
