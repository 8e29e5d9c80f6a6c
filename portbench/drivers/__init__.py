"""Traffic drivers: `<kind>.py` beside this file, named by a workload
file's "driver" key. Each has `setup(run)`, which builds the entry point
and warms up the cell's shapes, and `window(run)`, which measures."""
