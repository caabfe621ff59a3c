"""The port's measurement tools, run as modules: `bench_suite` (one record
per BASELINE.md config) and `scaling_bench` (the batch runner in one and
in two processes)."""
