"""Deterministic fault injection (a copy of the JAX package's ``distributed/faults.py``)."""
