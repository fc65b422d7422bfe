"""The benchmark of cfftpack_tpu_torch on one NVIDIA card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every cell of ``BENCHMARK.json`` is found by name: its configuration in
``configs/<config>.json`` with the module that drives the program beside
it (``<config>.py``) and the plain reference (``<config>_ref.py``), its
traffic in ``traffic/<mix>.json``, each metric's reader in
``metrics/<metric>.py``, the ideal bytes of a call in
``counts/<config>.py`` and the limits of the correctness check in
``limits/<cell>.json``.  A new cell, mix or metric is new files and new
entries; no file here needs an edit for it.  Nothing here imports JAX or
the JAX package.
"""
