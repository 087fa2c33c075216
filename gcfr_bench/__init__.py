"""The benchmark of geomconsistentfr_torch, the PyTorch and CUDA port (see BENCHMARK.json).

`python -m gcfr_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell once. Everything that belongs to one configuration, traffic mix,
driver or per-layer metric is a file of its own, found by name:
configs/, workloads/, drivers/, metrics/. reference/ is the plain float32
statement of the model, the renderer and the training step that decides
`correct`; work.py holds the operation and byte counts and the peaks.
"""
