"""The benchmark of canvas_tpu_torch on an NVIDIA H100.

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (at the repository's
root) and prints one JSON line. Configurations (``configs/*.json``),
traffic mixes (``traffic/*.json``), per-layer metric readers
(``metrics/<name>.py``), the kernels a roofline counts
(``kernels/*.json``) and each cell's correctness limits
(``limits/<cell>.json``) are found by name; ``reference/`` is the plain
reference the frames are judged against.

A configuration brings what the harness does not know as new files: a
layer kind as ``layers/<kind>.py`` and ``reference/layers/<kind>.py``
(``graph.py``), a post other than 'yuv420' as
``reference/posts/<post>.py`` (``check.py``), and its CPU rehearsal as
the ``rehearsal`` key of its configuration file (its ``window``;
``cells.rehearsal``). A cell of
``chips`` more than 1 renders over a ``Mesh`` of cards 0 to chips - 1
(``drive.py``).
"""
