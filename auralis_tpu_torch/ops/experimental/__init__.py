"""Decode-attention kernel of the port (the JAX package keeps its Pallas
counterpart under the same path)."""
