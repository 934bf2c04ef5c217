"""First-seen sidecars of the native slot feed (host code).

The port's copy of ``_native_sidecar`` and ``_merge_sidecars`` from
``pantas_tpu/parallel/distributed.py``. A resumed device augment uses them to
rebuild the single-stream first-seen orders (IL/OL offsets per node, novel
edges) from the run before the interruption and the run after it. The
multi-process augment that also uses them is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np


def _native_sidecar(tensors, eng) -> dict:
    """Convert the native engine's first-seen sidecars (slot order + byte
    positions) into the per-process dict format ``_merge_sidecars`` expects
    (the same structure the Python SlotEncoder records)."""
    il_seen: dict = {}
    ol_seen: dict = {}
    order, pos = eng.seen_sidecar()
    if len(order):
        t = tensors
        hist_total = int(t.ol_base[0] - t.il_base[0]) if t.n_nodes else 0
        il_end = int(t.il_base[0]) + hist_total
        for slot, p in zip(order, pos):
            slot = int(slot)
            if slot < il_end:
                ni = int(np.searchsorted(t.il_base, slot, side="right")) - 1
                il_seen.setdefault(ni, {})[slot - int(t.il_base[ni]) - 1] = int(p)
            else:
                ni = int(np.searchsorted(t.ol_base, slot, side="right")) - 1
                ol_seen.setdefault(ni, {})[slot - int(t.ol_base[ni]) - 1] = int(p)
    novel: dict = {}
    novel_first: dict = {}
    keys, vals, poss = eng.novel_sidecar()
    for k, v, p in zip(keys, vals, poss):
        key = (int(k >> np.uint64(32)), int(k & np.uint64(0xFFFFFFFF)))
        novel[key] = int(v)
        novel_first[key] = int(p)
    lib, h = eng.lib, eng.handle
    return {
        "rejected": int(lib.gafcov_rejected(h)),
        "skipped": int(lib.gafcov_skipped(h)),
        "accepted": int(lib.gafcov_accepted(h)),
        "il_seen": il_seen,
        "ol_seen": ol_seen,
        "novel": novel,
        "novel_first": novel_first,
    }


def _merge_sidecars(tensors, sidecars):
    """Rebuild the single-stream encoder state from per-process sidecars."""
    from pantas_tpu_torch.coverage.device import SlotEncoder

    enc = SlotEncoder(tensors)
    il: dict = {}
    ol: dict = {}
    for sc in sidecars:
        enc.rejected += sc["rejected"]
        enc.skipped += sc["skipped"]
        enc.accepted += sc["accepted"]
        for ni, d in sc["il_seen"].items():
            mine = il.setdefault(ni, {})
            for off, pos in d.items():
                if off not in mine or pos < mine[off]:
                    mine[off] = pos
        for ni, d in sc["ol_seen"].items():
            mine = ol.setdefault(ni, {})
            for off, pos in d.items():
                if off not in mine or pos < mine[off]:
                    mine[off] = pos
        for key, cnt in sc["novel"].items():
            if key not in enc.novel:
                enc.novel[key] = 0
                enc.novel_first[key] = sc["novel_first"][key]
            enc.novel[key] += cnt
            enc.novel_first[key] = min(enc.novel_first[key], sc["novel_first"][key])
    # global first-seen order = ascending first byte offset
    enc.il_seen = {
        ni: dict.fromkeys(sorted(d, key=d.__getitem__)) for ni, d in il.items()
    }
    enc.ol_seen = {
        ni: dict.fromkeys(sorted(d, key=d.__getitem__)) for ni, d in ol.items()
    }
    enc.novel_order = sorted(enc.novel, key=enc.novel_first.__getitem__)
    return enc
