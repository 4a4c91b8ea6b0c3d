"""Decode-attention kernels K2/K4 and the fused W8A8 MLP K5 of the port (the
JAX package keeps their Pallas counterparts under the same paths)."""
