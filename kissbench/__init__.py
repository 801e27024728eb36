"""kissbench: the benchmark of kiss_tpu_torch, the PyTorch and CUDA port.

One run drives one cell (a configuration under a traffic mix, both named
in ``BENCHMARK.json``) and prints one JSON line:

    python -m kissbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (which names its entry, ``entries/<entry>.py``),
``e2e/<metric>.py`` and ``metrics/<metric>.py``. The yardstick (the
generators, the plain reference, the bound arithmetic, the trace
reduction) lives here and imports nothing of the program besides its
entry points.
"""
