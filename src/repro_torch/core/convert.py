"""Carry a reference index across: read a ``repro`` checkpoint directory.

The port writes and reads the reference's checkpoint format to the letter
(``distributed/checkpoint.py``), so reading a checkpoint that
``repro.distributed.checkpoint.save_vectormaton`` wrote is the port's own
loader: the result is a port ``VectorMaton`` whose index is the
reference's — the same automaton, graphs and tombstones — answered by the
port's executor.
"""

from __future__ import annotations

from typing import Optional

from ..distributed.checkpoint import load_vectormaton
from .vectormaton import VectorMaton, VectorMatonConfig


def from_reference_checkpoint(path: str,
                              config: Optional[VectorMatonConfig] = None,
                              device: str = "cuda") -> VectorMaton:
    """Load the reference checkpoint at ``path`` into a port index.

    The index parameters (T, M, ef_con, metric, reuse, skip_build, seed,
    quantize, the compaction knobs and the schema) come from the
    checkpoint; ``config`` supplies the rest (backend, accum, plan mode)
    and ``device`` where the torch backend runs."""
    return load_vectormaton(VectorMaton, path, config=config, device=device)


__all__ = ["from_reference_checkpoint"]
