from vipnerf_tpu_torch.data.loaders.factory import get_data_loader  # noqa: F401
