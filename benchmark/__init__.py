"""The benchmark of the PyTorch and CUDA port: cells read from data files
(`README.md`)."""
