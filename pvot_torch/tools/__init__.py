"""Measurement and probe tools of the port, the counterparts of the
repository's tools/ scripts: `mega_breakdown` (K1's rung ladder) and
`global_strip_probe` (the global-strip probes), each run with
`python -m pvot_torch.tools.<name>`."""
