"""The benchmark of ``lfb_tpu_torch`` on one NVIDIA H100: see
``BENCHMARK.json`` and ``python3 -m gpubench.run --help``."""
