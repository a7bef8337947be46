"""The plain reference the benchmark judges the port by."""
