"""Filters of the port (the unpaper family so far) and their kernels."""
