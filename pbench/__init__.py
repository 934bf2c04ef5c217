"""The benchmark of ``pantas_tpu_torch`` on one NVIDIA H100: ``python3 -m pbench.run``.

``BENCHMARK.json`` at the root of the checkout names the cells; each
configuration, traffic mix, stage and metric is a file of its own under this
directory (see :mod:`pbench.run`). The yardstick, ``pbench/reference/``,
imports nothing of the program.
"""
