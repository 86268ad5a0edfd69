"""How each of the three kinds of cell runs: train, eval, serve."""
