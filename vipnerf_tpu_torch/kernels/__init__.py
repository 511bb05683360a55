"""Hand-written Hopper kernels and their plain torch versions.

Each kernel module holds a wrapper (launches the CUDA kernel on CUDA
tensors, runs the plain version on CPU tensors, counts its launches) and
the plain version. The CUDA sources are under `csrc/`; `build` compiles them
at first use.
"""
