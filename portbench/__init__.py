"""The benchmark of ``tensornetworkquantumsimulator_torch`` on an NVIDIA
H100: ``python3 -m portbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (``run.py``).  Configurations, traffic mixes, limits
and per-layer metrics sit in files of their own, found by the names in
``BENCHMARK.json``; the plain reference is in ``reference/``."""
