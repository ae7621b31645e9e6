"""The serving tier over the port's index (mirrors ``repro.serve``)."""
