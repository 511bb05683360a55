"""ViP-NeRF in PyTorch for an NVIDIA H100.

A port of `vipnerf_tpu` (the JAX package, which stays the reference) with the
same sub-package layout: `core/` (encoding, rays, poses, sampling,
compositing), `models/` (MLP and renderer), `kernels/` (the hand-written
Hopper kernels, their plain versions and K1's autograd), `losses/`, `infer/`
(tiled renderer with losses, tester), `data/` (loaders, the synthetic
database, the preprocessor in train, validation and test mode), `train/`
(LR schedules, Adam step, checkpoints, logging, `start_training`,
batched multi-scene training), `priors/`, `qa/`, `apps/`, `db_builders/`
(the three database builders) and `utils/` (I/O with nvJPEG for JPEGs,
the weight converter, the bridge to the JAX package's checkpoints).

Entry points run on the card unless the caller asks for the CPU
(`utils.device.resolve_device`). Kernels build at first use, never at import.
"""

__version__ = "0.1.0"
