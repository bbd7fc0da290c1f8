"""Benchmark of quemb_tpu_torch on one H100 (see BENCHMARK.json, PERF.md)."""
