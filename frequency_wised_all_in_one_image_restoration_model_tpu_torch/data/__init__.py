"""Data for evaluation: test-set indexing, decoding, synthetic test sets
(copies of the numpy parts of the JAX package's ``data/``)."""
