"""Mesh helpers of the port (the JAX package's ``sharding/``)."""
