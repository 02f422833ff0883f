"""Benchmark of the PyTorch and CUDA port on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. The cell names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); the traffic file names the entry
(``entries/<entry>.py``) that builds the system under test, feeds it for
the window and hands the window's outputs to the comparison. Each
per-layer metric is a reader of its own (``metrics/<name>.py``). The
yardstick (work counts, the peaks, the plain reference, the comparison)
lives here and reads nothing the program made.
"""
