"""The plain reference of the benchmark: float64 PyTorch over the benchmark's
own COO triplets and vectors. It imports nothing of the program under test."""
