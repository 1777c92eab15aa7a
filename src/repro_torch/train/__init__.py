"""Training-state construction for the port (the dense family)."""
