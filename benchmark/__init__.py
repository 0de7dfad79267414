"""The benchmark of the PyTorch and CUDA port
(`multimodal_emotion_processing_tpu_torch`) on one NVIDIA H100.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` and prints its result
as the last line of standard output.  Everything a cell needs is found by
name: its configuration in `configs/`, its traffic mix in `traffic/`
(data that one driver module of `drivers/` reads), its correctness limits
in `limits/`, each per-layer metric's reader in `metrics/`; `reference/`
holds the plain PyTorch yardstick.
"""
