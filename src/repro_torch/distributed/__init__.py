"""Index checkpoints, replica groups and failure detection (mirrors
``repro.distributed``; the sharded executor is not ported yet)."""
