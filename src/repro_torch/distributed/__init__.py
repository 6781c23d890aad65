"""Scale-out: the sharding rules as DTensor placements, int8 gradient
compression and the GPipe pipeline, the JAX package's ``distributed/`` over
``torch.distributed``."""
