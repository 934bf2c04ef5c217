"""pantas_tpu_torch — the PyTorch / CUDA port of pantas_tpu, for one NVIDIA H100.

The device layer of the augment stage runs here: the native C++ GAF parser
streams count-slot indices, a hand-written Hopper kernel adds them into the
flat ``[NC | IL | OL | RC]`` counts vector on the card, and the native engine
writes the byte-identical augmented GFA (``pantas_tpu_torch.coverage``).
The call stage's device engine matches the bitset finders' candidates on the
card as torch ops (``pantas_tpu_torch.events``). The host stages the
pipeline needs around them (build, the host augment engines, the host
caller, quant, remap) are this package's own copies of ``pantas_tpu``'s host
modules, under the same sub-package and file names. Nothing here imports
``jax`` or anything of ``pantas_tpu``.
"""

__version__ = "0.1.0"
