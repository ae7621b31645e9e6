"""Index, planner and executor of the port (mirrors ``repro.core``)."""
