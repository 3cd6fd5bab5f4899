"""pvbench: the benchmark of pvot_torch, driven by the data in BENCHMARK.json."""
