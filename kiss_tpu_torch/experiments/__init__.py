"""The port's measuring modules, counterparts of the JAX package's
``experiments/`` and ``tools/``, each run as ``python -m
kiss_tpu_torch.experiments.<name>``: the card's probes (``micro_kernels``,
``micro_copy``), the sorts by device kernel (``sort_split``), the query
kernels alone (``fm_query_time``), the out-of-core routes
(``external_scale``, ``chm13_full``, ``spot_external_anyk``), the
reference's experiment protocol (``run_experiments``) and the sort's
roofline (``micro_roofline``)."""
