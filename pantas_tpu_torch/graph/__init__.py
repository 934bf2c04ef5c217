"""Tensorized graph compiler: annotated GFA -> immutable dense arrays."""

from pantas_tpu_torch.graph.compiler import GraphTensors, compile_gfa  # noqa: F401
