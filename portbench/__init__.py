"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON result line. Everything the harness needs is found by name:

* ``configs/<config>.json``: the model as run (widths, multipliers, dtype),
  its public source and each way the port departs from it;
* ``mixes/<traffic>.json``: the traffic's parameters and the driver kind;
* ``drivers/<kind>.py``: how a kind of traffic drives the port;
* ``metrics/<metric>.py``: one reader per per-layer metric, or the file
  of its base name (up to the first dot) that its variants share;
* ``limits/<cell>.json``: the limits of the comparison that decides
  ``correct``, with the readings they were set from;
* ``reference/``: the plain PyTorch reference, which imports nothing of
  the port;
* ``held.json``: cells kept out of ``BENCHMARK.json`` for now, in its
  form, which ``run.py`` and the tests still find by name.
"""
