"""The benchmark's yardstick: frozen input generators and plain references.

Nothing here imports the program (``pantas_tpu_torch``), the JAX package or
JAX, so nothing the program makes reaches what the reference reads.
"""
