"""Distribution layer of the port: mesh, halo exchange, rows-sharded
pipelines, multi-process init, the batch runner and its heartbeat."""

from .batch import BatchMetrics, BatchRunner, map_chunked
from .dryrun import dryrun_multichip
from .halo import exchange_halo_rows, sharded_stencil
from .mesh import (PAGES_AXIS, ROWS_AXIS, Mesh, ShardedPages, make_mesh,
                   map_sharded_pages, page_sharding, replicated, shard_pages)
from .multihost import (Heartbeat, initialize_distributed, make_host_mesh,
                        process_allgather)
from .pipeline import (DOCUMENT_CLEANUP, EDGE_STACK, compile_pipeline,
                       normalize_spec, run_pipeline)

__all__ = [
    "BatchMetrics", "BatchRunner", "exchange_halo_rows", "sharded_stencil",
    "Heartbeat", "initialize_distributed", "make_host_mesh",
    "PAGES_AXIS", "ROWS_AXIS", "make_mesh", "page_sharding", "replicated",
    "shard_pages", "DOCUMENT_CLEANUP", "EDGE_STACK", "compile_pipeline",
    "normalize_spec", "run_pipeline",
    "Mesh", "ShardedPages", "dryrun_multichip", "map_chunked",
    "map_sharded_pages", "process_allgather",
]
