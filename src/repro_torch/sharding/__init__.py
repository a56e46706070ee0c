"""Logical-axis sharding rules and FSDP specs (port of ``repro.sharding``)."""
