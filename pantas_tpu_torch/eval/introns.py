"""Intron length distribution: extraction from GTF + log-normal mixture fit.

Equivalent of the reference's
``exps/3-homo-real/workflow/scripts/intron_length_distribution.py``: parse
per-transcript intron lengths from a GTF and fit a log-normal mixture by
EM, selecting the component count by BIC (1..5) and writing the model file
(first line = component count, then the mixture weights, then per-component
``sigma, mu`` pairs — same layout as the reference's output,
``intron_length_distribution.py:593-601``).

The parser replicates the reference's semantics exactly
(``intron_length_distribution.py:15-52``; differential-tested):

* only ``exon`` rows; strand swaps (start, end) so minus-strand introns run
  right-to-left;
* intron length = ``abs(start - prev_end) - 1``;
* the first exon of each transcript only primes ``curr_tx``/``prev_end``
  (the ``else`` branch), so cross-transcript gaps are never counted;
* ``unique`` de-duplicates on the (chrom, strand, prev_end, start) tuple.

The mixture fit is our own vectorized EM. The reference initializes
responsibilities with random Dirichlet draws
(``intron_length_distribution.py:238-261``, ``stats.dirichlet.rvs``), so
its output is not reproducible run-to-run; we use a deterministic
quantile-spread init instead (same model family, stable tests). Weighted
(value, count) form keeps every step O(distinct lengths × components).
"""

from __future__ import annotations

import math
import sys
from collections import Counter
from typing import Dict, Tuple

import numpy as np

_ROOT_2PI = math.sqrt(2.0 * math.pi)


def intron_length_distr(filepath: str, label: str = "transcript_id", unique: bool = False) -> Counter:
    """Per-transcript intron length counts from a GTF (reference-exact)."""
    observed = set()
    lengths: Counter = Counter()
    curr_tx = None
    prev_end = None
    with open(filepath) as f:
        for line in f:
            if line.startswith("#"):
                continue
            tokens = line.strip().split("\t")
            if tokens[2] != "exon":
                continue
            chrom = tokens[0]
            strand = tokens[6] == "+"
            if strand:
                start, end = int(tokens[3]), int(tokens[4])
            else:
                start, end = int(tokens[4]), int(tokens[3])
            tx_id = None
            for annotation in tokens[8].strip().split(";"):
                annotation = annotation.replace('"', "").strip()
                if annotation.startswith(label):
                    tx_id = annotation.split()[1]
                    break
            assert tx_id is not None
            intron = (chrom, strand, prev_end, start)
            if tx_id == curr_tx and (not unique or intron not in observed):
                lengths[abs(start - prev_end) - 1] += 1
                observed.add(intron)
            else:
                curr_tx = tx_id
            prev_end = end
    return lengths


def _weighted_arrays(counter: Counter) -> Tuple[np.ndarray, np.ndarray]:
    assert 0 not in counter, "zero-length intron cannot be log-transformed"
    vals = np.array(sorted(counter), dtype=np.float64)
    counts = np.array([float(counter[int(v)]) for v in vals])
    return vals, counts


def fit_log_normal_mixture(
    counter: Counter,
    num_comps: int,
    max_iters: int = 500,
    tol: float = 1e-6,
) -> Tuple[np.ndarray, np.ndarray]:
    """EM fit of a ``num_comps``-component log-normal mixture.

    Returns (params, weights) with params[2j] = sigma_j, params[2j+1] =
    mu_j in log space (the reference's parameter layout,
    ``intron_length_distribution.py:338-349``).
    """
    vals, counts = _weighted_arrays(counter)
    x = np.log(vals)  # (n,)
    n = len(x)
    total = counts.sum()

    # deterministic init: component means at evenly spaced weighted
    # quantiles, shared sigma from the global spread
    cum = np.cumsum(counts) / total
    qs = (np.arange(num_comps) + 0.5) / num_comps
    mu = np.array([x[np.searchsorted(cum, q)] for q in qs])
    gmu = float(np.average(x, weights=counts))
    gsd = float(np.sqrt(np.average((x - gmu) ** 2, weights=counts)))
    sigma = np.full(num_comps, max(gsd / num_comps, 1e-3))
    weights = np.ones(num_comps) / num_comps

    for _ in range(max_iters):
        # E step: responsibilities (n, k) in log space for stability
        logp = (
            np.log(weights)[None, :]
            - np.log(sigma)[None, :]
            - math.log(_ROOT_2PI)
            - 0.5 * ((x[:, None] - mu[None, :]) / sigma[None, :]) ** 2
        )
        m = logp.max(axis=1, keepdims=True)
        z = np.exp(logp - m)
        z /= z.sum(axis=1, keepdims=True)

        # M step (weighted by counts)
        zc = z * counts[:, None]  # (n, k)
        m0 = zc.sum(axis=0)  # (k,)
        new_mu = (zc * x[:, None]).sum(axis=0) / m0
        new_sigma = np.sqrt(
            (zc * (x[:, None] - new_mu[None, :]) ** 2).sum(axis=0) / m0
        )
        new_sigma = np.maximum(new_sigma, 1e-6)
        new_weights = m0 / total

        delta = max(
            float(np.abs(new_weights - weights).max()),
            float(np.abs(new_mu - mu).max()),
            float(np.abs(new_sigma - sigma).max()),
        )
        mu, sigma, weights = new_mu, new_sigma, new_weights
        if delta < tol:
            break

    params = np.empty(2 * num_comps)
    params[0::2] = sigma
    params[1::2] = mu
    return params, weights


def log_normal_bic(counter: Counter, params: np.ndarray, weights: np.ndarray) -> float:
    """BIC of a fitted mixture (reference's scoring,
    ``intron_length_distribution.py:539-556``: density of the length itself
    is the log-space normal divided by the value)."""
    vals, counts = _weighted_arrays(counter)
    log_vals = np.log(vals)
    sigma, mu = params[0::2], params[1::2]
    z = (log_vals[:, None] - mu[None, :]) / sigma[None, :]
    dens = (weights[None, :] * np.exp(-0.5 * z * z) / (sigma[None, :] * _ROOT_2PI)).sum(
        axis=1
    ) / vals
    log_likelihood = float((counts * np.log(dens)).sum())
    p = len(params) + len(weights) - 1
    return p * math.log(float(counts.sum())) - 2.0 * log_likelihood


def estimate(
    gtf_path: str,
    out_path: str,
    label: str = "transcript_id",
    max_comps: int = 5,
    log=sys.stderr,
) -> int:
    """Fit 1..max_comps models, select by BIC, write the model file.

    Returns the selected component count.
    """
    lengths = intron_length_distr(gtf_path, label)
    if not lengths:
        raise ValueError(f"no introns found in {gtf_path}")
    best = None
    for k in range(1, max_comps + 1):
        params, weights = fit_log_normal_mixture(lengths, k, max_iters=500 * k)
        bic = log_normal_bic(lengths, params, weights)
        if log:
            print(f"{k} component model achieves BIC {bic}", file=log)
        if best is None or bic < best[0]:
            best = (bic, k, params, weights)
    _, k, params, weights = best
    with open(out_path, "w") as f:
        print(str(k), file=f)
        for param in list(weights) + list(params):
            print(str(param), file=f)
    return k
