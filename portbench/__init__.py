"""The benchmark of ``eyegaze_tpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Every
configuration (``configs/``), traffic mix (``traffic/``) and per-layer
metric (``metrics/``) is a file found by its name; the plain reference that
decides ``correct`` is ``reference/``.  Nothing here imports JAX or the JAX
package.
"""
