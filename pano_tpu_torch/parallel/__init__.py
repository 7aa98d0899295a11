"""Batched and multi-device execution of the port (``shard``)."""
