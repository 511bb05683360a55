"""The ViP-NeRF losses and their weighted sum."""

from vipnerf_tpu_torch.losses.computer import LossComputer  # noqa: F401
