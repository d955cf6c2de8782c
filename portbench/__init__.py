"""The benchmark of the PyTorch/CUDA port (``demuxlet_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once: whole demultiplexing jobs (engine,
``run_compact``, ``cell_stats``, rendering) back to back for the window,
then checks every job's compact rows and a sample of its rendered text
against the plain reference in ``reference.py``, and prints one JSON line.

Cells, configurations, traffic mixes and per-layer metrics are files found
by name: ``BENCHMARK.json`` names a cell's configuration
(``configs/<config>.json``) and traffic mix (``traffic/<mix>.json``), and
each per-layer metric has its reader in ``metrics/<metric>.py``.
"""
