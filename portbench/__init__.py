"""The benchmark of the PyTorch and CUDA port (``edgellm_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything a cell needs is found by name: the configuration in
``configs/<config>.json``, the traffic mix in ``traffic/<traffic>.json``
(whose ``kind`` names the driver ``kinds/<kind>.py``), and each per-layer
metric in ``metrics/<metric>.py``. ``yardstick/`` holds the operation and
byte counts and the published peaks; ``reference/`` holds the plain
PyTorch reference that decides ``correct``. Nothing here imports JAX or the
JAX package, and ``reference/`` imports nothing of the port.
"""
