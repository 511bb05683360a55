"""Offline database builders (counterpart of vipnerf_tpu/db_builders/):
convert downloaded source datasets (the NeRF-LLFF zip, RealEstate-10K camera
files and videos, the DTU pixelNeRF and RegNeRF archives) into the
framework's on-disk database layout, with the JAX package's functions, CLI
flags and outputs, on the GPU machine's libraries: CSVs with `csv`, JSON
with `json`, PNGs with the port's codec, JPEGs with nvJPEG on the card,
video frames with the ffmpeg tool."""
