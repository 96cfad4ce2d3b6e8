"""The benchmark of fastsk_tpu_torch: see BENCHMARK.json and PERF.md."""
