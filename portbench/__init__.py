"""portbench: the benchmark of chase_tpu_torch on one NVIDIA H100.

``python3 portbench/run.py --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once and prints one JSON line.
Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and its generator ``traffic/<mode>.py``,
``matrices/<family>.py`` and ``metrics/<metric>.py``; the plain reference
that decides ``correct`` is ``reference/`` (``reference/<family>.py``,
``reference/judges/<judge>.py``).  Nothing here imports ``jax``,
``jaxlib`` or ``chase_tpu``; ``reference/`` imports nothing of
``chase_tpu_torch``.
"""
