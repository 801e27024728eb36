from kiss_tpu_torch.utils import codec, fasta, serializer, timing  # noqa: F401
