"""Filters of the port (unpaper, gaussian, sobel, canny, ACE) and their
kernels."""
