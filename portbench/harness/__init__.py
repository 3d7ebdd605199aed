"""Harness of the port's benchmark: cells, traffic, weights, tracing, comparison."""
