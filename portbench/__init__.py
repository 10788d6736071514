"""The benchmark of butterfly_tpu_torch, the PyTorch and CUDA package.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` (or `python3 -m portbench.run ...`) runs one cell of
`BENCHMARK.json` on one card and prints one JSON line. See `harness.py`
for how cells, configurations, traffic mixes and metrics are found by
name, and `reference/` for the plain reference that decides `correct`.
"""
