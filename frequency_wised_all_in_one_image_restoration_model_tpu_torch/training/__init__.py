"""Checkpoints; the training steps come with the training slice."""
