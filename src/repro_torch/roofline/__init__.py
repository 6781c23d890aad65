"""Roofline model of the port's steps on the H100: hardware constants, an
op-level cost counter and the roofline terms, the JAX package's
``roofline/``."""
