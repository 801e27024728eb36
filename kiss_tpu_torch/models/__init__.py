from kiss_tpu_torch.models.fm_index import FMIndex  # noqa: F401
