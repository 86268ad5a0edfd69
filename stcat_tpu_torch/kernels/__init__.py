"""Hand-written CUDA kernels (csrc/*.cu) with their plain PyTorch versions.

Each wrapper launches its kernel on CUDA tensors (or raises) and runs the
plain version on CPU tensors; ``LAUNCHES`` counts kernel launches. Nothing
is compiled or loaded until a kernel is first launched.
"""
