"""ViP-NeRF model family: the MLP module and the coarse+fine renderer."""
