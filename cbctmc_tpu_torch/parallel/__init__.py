"""The engine distributed over ranks (``torch.distributed``): the port of
the JAX package's ``parallel/``."""
