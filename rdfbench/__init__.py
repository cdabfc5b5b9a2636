"""The benchmark of the PyTorch and CUDA port of AdHash (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 rdfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one deployment, one traffic mix or one per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``.
The data generators (``gen/``), the plain reference (``reference/``), the
comparison that decides ``correct`` (``check.py``) and the byte counts of
the kernels' rooflines (``roofline.py``) live here too, apart from the
program they measure.
"""
