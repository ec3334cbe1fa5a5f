"""The benchmark of the PyTorch and CUDA port (``ndt_2d_tpu_torch``).

Run one cell with ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; ``BENCHMARK.json``
lists the cells, and PERF.md says why each exists.
"""
