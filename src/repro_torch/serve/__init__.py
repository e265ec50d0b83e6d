"""Fixed-batch greedy serving."""
