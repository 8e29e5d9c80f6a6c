"""Cells: `<cell name>.json` beside this file holds the cell's
configuration, its driver and its traffic's parameters."""
