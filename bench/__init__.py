"""The benchmark of the port (see BENCHMARK.json)."""
