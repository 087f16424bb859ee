"""The plain reference: plain PyTorch that recomputes, from the inputs the
benchmark made, what the timed path produced. It imports nothing of the
program (``repro_torch``), nor ``jax`` or the JAX package."""
