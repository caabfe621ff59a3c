"""Pipelines of the port."""

from .pipeline import (DOCUMENT_CLEANUP, compile_pipeline, normalize_spec,
                       run_pipeline)

__all__ = ["DOCUMENT_CLEANUP", "compile_pipeline", "normalize_spec",
           "run_pipeline"]
