"""Training losses of the port."""
