"""The benchmark's harness: cells, traffic, the timed window, traces, bounds, checks."""
