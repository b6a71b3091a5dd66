"""Inputs the benchmark makes from its seed: images, PNG files, weights, the
vocabulary file, and the flax bytes the port reads weights from."""
