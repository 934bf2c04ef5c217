"""Graph-coordinate to linear-reference-coordinate remapping."""

from pantas_tpu_torch.remap.remap import remap  # noqa: F401
