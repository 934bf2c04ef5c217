"""pantas_tpu_torch — the PyTorch / CUDA port of pantas_tpu, for one NVIDIA H100.

The device layer of the augment stage runs here: the native C++ GAF parser
streams count-slot indices, a hand-written Hopper kernel adds them into the
flat ``[NC | IL | OL | RC]`` counts vector on the card, and the native engine
writes the byte-identical augmented GFA (``pantas_tpu_torch.coverage``).
The call stage's device engine matches the bitset finders' candidates on the
card as torch ops (``pantas_tpu_torch.events``). Host-only stages (build,
map, the host caller, quant, remap, …) are ``pantas_tpu``'s own code,
reached through this package's CLI. Nothing here imports ``jax``.
"""

__version__ = "0.1.0"
