"""Configs, weight loading and image helpers of the PyTorch port."""
