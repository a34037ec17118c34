"""The benchmark of ``gaze_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once from the root of a checkout and prints
one JSON line. Everything a cell needs is found by name:

- ``BENCHMARK.json`` (the repository root): the cells, their
  configuration and traffic names, the metrics;
- ``configs/<config>.json``: the model's sizes and the precision of each
  op family;
- ``traffic/<mix>.json``: the traffic's parameters and its ``kind``,
  the driver in ``kinds/<kind>.py`` that sets the cell up, runs the
  window and checks what it produced;
- ``workloads/<cell>.json``: the limits of the cell's correctness check
  and its control (the program's own path one precision step below);
- ``metrics/<name>.py``: one reader per per-layer metric;
- ``roofline/``: the operation and byte counts and the chip's peaks;
- ``reference/``: the plain model the check holds the program to, exact
  and at the configuration's stated precisions (``compare.py``).

The program under test is the ``gaze_tpu_torch`` package; nothing here
imports JAX or the JAX package.
"""
