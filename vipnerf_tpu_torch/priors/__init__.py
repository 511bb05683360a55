"""Offline prior generators: the dense visibility prior (a plane sweep on
the GPU) and the sparse-depth prior (external COLMAP)."""
