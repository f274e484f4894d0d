"""Meshes of ranks and the sharding policy (port of ``repro.launch``'s
``mesh`` and ``sharding``)."""
