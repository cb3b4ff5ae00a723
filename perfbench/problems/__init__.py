"""Data generators, one module per kind of problem, found by the name a
configuration's ``problem`` key gives. Each makes its inputs from the seed
alone and imports nothing of the program."""
