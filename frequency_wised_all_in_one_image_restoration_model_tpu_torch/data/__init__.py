"""Data: train loaders and test sets, file-backed and synthetic, decoding,
augmentation, prefetch (copies of the numpy parts of the JAX package's
``data/``)."""
