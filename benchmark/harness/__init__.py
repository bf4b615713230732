"""The port's benchmark harness: cells, configurations, traffic and metrics
are found by name from BENCHMARK.json and the files under benchmark/."""
