"""Pipelines of the port."""

from .pipeline import (DOCUMENT_CLEANUP, EDGE_STACK, compile_pipeline,
                       normalize_spec, run_pipeline)

__all__ = ["DOCUMENT_CLEANUP", "EDGE_STACK", "compile_pipeline",
           "normalize_spec", "run_pipeline"]
