"""Coverage accumulation of the port: the per-read semantics and the host
engine (:mod:`.semantics`, :mod:`.host`), the device augment engine
(:mod:`.device`), the scatter selection and its races
(:mod:`.scatter_impls`, :mod:`.bench_scatter`), the kernel wrappers
(:mod:`.kernels`) and the nvcc build of the kernel sources (:mod:`._build`).
Nothing is imported here."""
