"""Hardware probes of the card (counterparts of the TPU probes under
``experiments/``): ``python -m kiss_tpu_torch.experiments.micro_kernels``
and ``python -m kiss_tpu_torch.experiments.micro_copy``."""
