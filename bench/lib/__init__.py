"""The harness: reading a cell from data, the run, the trace, the
comparison."""
