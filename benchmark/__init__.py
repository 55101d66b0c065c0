"""The benchmark of ``rtm3d_tpu_torch`` on NVIDIA H100s.

One run of one cell: ``python3 -m benchmark.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Everything a cell
is made of is data found by name: the configuration's file under
``configs/``, the traffic mix under ``traffic/`` (read by the driver its
``kind`` names, ``drivers/<kind>.py``), the cell's limits under
``workloads/`` and one reader a metric under ``metrics/``. The plain
reference that decides ``correct`` is under ``reference/``; it imports
nothing of the program.
"""
