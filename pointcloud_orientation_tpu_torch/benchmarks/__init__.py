"""Micro-benchmarks of the port's kernels on the card."""
