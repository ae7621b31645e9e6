"""Sharded search, index checkpoints, replica groups and failure
detection (mirrors ``repro.distributed``)."""
