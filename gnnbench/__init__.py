"""The benchmark of the PyTorch and CUDA port of GTA.

``python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one CUDA card and
prints one JSON line.  Everything that belongs to one configuration, one
traffic mix or one per-layer metric is a file of its own, found by name:
``configs/<config>.json``, ``mixes/<traffic>.json``,
``metrics/<metric>.py`` (or ``metrics/<base>.py`` for ``<base>.<suffix>``),
``limits/<cell>.json``, ``work/<family>.py`` and ``reference/<family>.py``.

Only ``program.py`` imports the port; nothing here imports JAX or the JAX
package.
"""
