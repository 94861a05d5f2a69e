"""Contributed front ends of the port: ``mixed_precision`` (AMP).
Ported from the JAX package's ``contrib``."""
