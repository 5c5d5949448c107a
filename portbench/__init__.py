"""The benchmark of ``lrcn_tpu_torch`` on one NVIDIA H100.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line last.  Everything here that belongs to one configuration, one
traffic mix or one metric sits in a file of its own, found by its name:

- ``configs/<config>.json``: the sizes as they are run;
- ``traffic/<traffic>.json``: the parameters of a mix, read by the
  driver it names, ``drivers/<driver>.py``;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)``;
- ``work/``: the operations and bytes of each layer, from shapes;
- ``reference/``: the plain float32 models that decide ``correct``.

Nothing here imports ``jax`` or ``lrcn_tpu``; ``reference/`` imports
nothing of ``lrcn_tpu_torch`` either.
"""
