"""Synthetic corpora (copied from ``repro.data``)."""
