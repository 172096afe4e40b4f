"""The benchmark of the PyTorch and CUDA port (``curvature_tpu_torch``) on
one card: ``python gpubench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``, driven by ``BENCHMARK.json`` and the data files
beside this one."""
