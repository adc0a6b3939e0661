"""Training state, steps and loops of the port."""
