"""The port's direct coverage scatter vs the JAX package's Pallas kernel.

The same seeded numpy inputs (``test_torch_kernels._case``) go through
``pantas_tpu.coverage.pallas_kernel.coverage_scatter_add``, the one-hot
read-modify-write TPU kernel run in Pallas interpret mode on the CPU, and the
port's ``coverage_scatter_add`` (its plain version on the CPU). Integer adds
are exact in any order, so the comparison is equality. Interpret mode costs
~1.5 ms per index here, so the cases are the smallest and the skewed ones
(one slot, long runs over the 2,048 boundary, equal slots far apart, all
padding, slots at and just past ``n``: the TPU kernel reads out of bounds
for a slot past its last (8, 128) tile, so those are held against the XLA
scatter only); the rest of the direct kernel's cases run
against the XLA scatter in ``test_torch_kernels``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from test_torch_kernels import _case, _expected

from pantas_tpu.coverage.pallas_kernel import coverage_scatter_add as tpu_direct_scatter
from pantas_tpu_torch.coverage import kernels


@pytest.mark.parametrize("case", ["mix-5000x4096", "all-equal", "below-one-window",
                                  "runs-cross-block", "equal-far-apart", "all-padding",
                                  "at-n"])
def test_port_direct_scatter_matches_pallas_onehot(case):
    counts, idx = _case(case)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(tpu_direct_scatter(jnp.asarray(counts), jnp.asarray(idx)))
    port = kernels.coverage_scatter_add(
        torch.from_numpy(counts.copy()), torch.from_numpy(idx)
    ).numpy()
    assert np.array_equal(pallas, _expected(counts, idx))
    assert np.array_equal(port, pallas)
