"""Helpers around the ops: the C oracle's binding, metrics, and synthetic
pages for smoke runs and timing."""

from . import oracle

__all__ = ["oracle"]
