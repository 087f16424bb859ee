"""CPU tests of the benchmark (no card needed)."""
