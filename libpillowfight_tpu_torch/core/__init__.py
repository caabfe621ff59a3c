"""Image model and constants of the port."""
