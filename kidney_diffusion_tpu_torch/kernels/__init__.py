"""Hand-written CUDA kernels for Hopper (`csrc/*.cu`), each beside its
plain PyTorch version and a launch counter.

Built at first use with `nvcc` into plain-C shared libraries loaded with
`ctypes` (`_build.py`); nothing is compiled when a module is imported."""
