"""Training: objective, state and step, and the epoch loop."""
