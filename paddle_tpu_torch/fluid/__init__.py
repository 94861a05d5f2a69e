"""Process-wide flags (a copy of the JAX package's ``fluid/flags.py``)."""
