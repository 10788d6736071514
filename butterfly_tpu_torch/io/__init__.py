"""Checkpointing of operators, butterflies and the streaming factorizer
(counterpart of `butterfly_tpu/io/`)."""
