from kiss_tpu_torch.ops import pack, suffix_sort  # noqa: F401
