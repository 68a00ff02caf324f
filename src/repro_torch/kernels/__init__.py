"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and the wrappers that choose between them (``ops``).

Nothing here touches CUDA at import: ``_build`` compiles and loads a
kernel the first time a wrapper is handed a CUDA tensor.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
