"""Training: losses, train state, the two-phase steps, the loop, checkpoints."""
