"""Every model configuration of the JAX package, as data (``registry``).
The port's model stack runs the dense family so far (``ROADMAP.md``)."""
