"""Plain PyTorch and numpy references of what a cell's timed path computes.
Nothing here imports the program, jax or the JAX package."""
