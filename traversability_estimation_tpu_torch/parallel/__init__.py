"""The map tiled over processes (``torch.distributed``): see ``sharding``
and ``multihost``."""
