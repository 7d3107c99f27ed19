"""The benchmark of canvas_tpu_torch on an NVIDIA H100.

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (at the repository's
root) and prints one JSON line. Configurations (``configs/*.json``),
traffic mixes (``traffic/*.json``), per-layer metric readers
(``metrics/<name>.py``), the kernels a roofline counts
(``kernels/*.json``) and each cell's correctness limits
(``limits/<cell>.json``) are found by name; ``reference/`` is the plain
reference the frames are judged against.
"""
