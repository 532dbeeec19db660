"""The benchmark of posfeat_tpu_torch on NVIDIA H100 cards.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. Everything that belongs to one
configuration, traffic mix, job or per-layer metric is a file of its own,
found by name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``jobs/<job>.py``, ``metrics/<metric>.py`` and ``limits/<cell>.json``.
``reference/`` holds the plain PyTorch reference that decides ``correct``;
it imports nothing of the program.
"""
