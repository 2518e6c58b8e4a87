"""The benchmark of ``mcm_tpu_torch`` on NVIDIA H100 cards.

One run scores one cell of ``BENCHMARK.json`` once::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<name>.json``) and
its traffic mix (``traffic/<name>.json``, whose ``driver`` names a module
of ``drivers/``); ``workloads/<cell>.json`` holds what belongs to the cell
alone (a serving rate, the limits of its output check); each per-layer
metric is a reader ``metrics/<name>.py``.  The plain reference that
decides ``correct`` is the module that the configuration's ``reference``
key names (``reference/clip.py`` for CLIP); it imports nothing of the
program.  Nothing here imports ``jax`` or the JAX package.
"""
