"""Per-layer metrics: `<metric name>.py` beside this file, one per metric
of `BENCHMARK.json`'s "per_layer" list, each with `read(records)`, which
returns the metric's value, or None where the traced run holds nothing
for it to read."""
