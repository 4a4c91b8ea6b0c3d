"""Decode loop, sampler and async runner of the port."""
