"""Plain references the benchmark judges the port by: NumPy only, and
nothing of the program."""
