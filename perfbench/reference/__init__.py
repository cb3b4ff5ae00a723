"""The plain reference: float64 PyTorch that imports nothing of the program
and works out again from the benchmark's inputs whatever the program's set-up
derives from them."""
