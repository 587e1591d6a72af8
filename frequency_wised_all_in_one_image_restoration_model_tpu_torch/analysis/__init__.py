"""Offline analysis toolkit of the port (the JAX package's ``analysis/``):
the library behind the CLIs of ``scripts/``, one per root ``plot_*.py``."""
