"""Plain reference for the benchmark's ``correct``: bootstrap embedding
worked out again from the benchmark's own inputs, in float64 NumPy and
PyTorch, with nothing imported from the program under test."""
