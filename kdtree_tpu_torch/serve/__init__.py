"""Serving: the engine facade every k-NN micro-batch goes through."""
