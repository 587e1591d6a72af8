"""Multi-GPU runs: the mesh layout and sharding rules (``mesh``), ranks,
the process group and its collectives (``distributed``)."""
