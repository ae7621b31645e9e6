"""Hand-written Hopper kernels, their plain PyTorch versions and the
executor wrappers around them (mirrors ``repro.kernels``)."""
