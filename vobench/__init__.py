"""The benchmark of `visualodometry_tpu_torch` on one NVIDIA GPU.

`python3 vobench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line. Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name:
`configs/<config>.json`, `traffic/<mix>.json`, `limits/<cell>.json`,
`metrics/<metric>.py`. `harness/` is the general code, `reference/` the
plain reference that decides `correct`.
"""
