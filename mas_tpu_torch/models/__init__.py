"""Models of the PyTorch port (serving path)."""
