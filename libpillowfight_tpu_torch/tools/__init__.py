"""The port's measurement tools, run as modules: `bench_suite` (one record
per BASELINE.md config), `scaling_bench` (the batch runner in one and in
two processes) and the six `profile_*` tools (the chain, its filters'
parts, the blackfilter, the floods, SWT and every filter, stage by
stage). `timing` holds what they share, the headline measurement of
`bench_torch.py` among it."""
