"""Serving: the engine facade every k-NN micro-batch goes through, the
admission queue, the micro-batcher, fault injection, and the HTTP front
(``serve/server.py``)."""
