"""Pipelines of the port, the batch runner and its heartbeat."""

from .batch import BatchMetrics, BatchRunner, map_chunked
from .multihost import Heartbeat
from .pipeline import (DOCUMENT_CLEANUP, EDGE_STACK, compile_pipeline,
                       normalize_spec, run_pipeline)

__all__ = ["BatchMetrics", "BatchRunner", "Heartbeat", "map_chunked",
           "DOCUMENT_CLEANUP", "EDGE_STACK", "compile_pipeline",
           "normalize_spec", "run_pipeline"]
