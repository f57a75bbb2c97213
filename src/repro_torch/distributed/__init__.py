"""Data-parallel collectives and the sharding rules: the port of
``repro/distributed`` (``compression``, ``sharding``; ``collectives``
holds the reduce-scatter both backends run)."""
