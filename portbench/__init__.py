"""The benchmark of the PyTorch and CUDA port: `python3 -m portbench.run`
runs one cell of `BENCHMARK.json` once (see README.md)."""
