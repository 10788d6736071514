"""Runnable twins of the JAX package's `examples/` scripts, run as
`python -m butterfly_tpu_torch.examples.<name>`."""
