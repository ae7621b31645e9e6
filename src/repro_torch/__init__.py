"""PyTorch/CUDA port of the VectorMaton system (``src/repro`` is the JAX
reference).  Entry point: ``repro_torch.core.vectormaton.VectorMaton``
with ``VectorMatonConfig(backend="torch", device="cuda")``; pass
``device="cpu"`` for the plain PyTorch path on the CPU."""
