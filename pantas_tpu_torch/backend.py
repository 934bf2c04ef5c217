"""Device selection and the card's label.

The port never picks a device on its own: callers name one, and asking for
CUDA where there is none is an error, not a quiet move to the CPU.
"""

from __future__ import annotations

import subprocess
import sys

import torch


def device(name) -> torch.device:
    """``torch.device(name)``; raises if it names CUDA and CUDA is absent."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but torch.cuda.is_available() is False")
    return dev


def devices(name, n: int = 1) -> list:
    """``n`` devices of type ``name`` for ``call --mesh n``. CUDA: the first
    ``min(n, device_count())`` cards; when there are fewer than ``n`` it
    prints the JAX CLI's warning and uses what there is. ``cpu``: the CPU
    device ``n`` times, a logical mesh as :func:`mesh_devices` gives
    ``augment``, so that the candidate axis is sharded on the CPU as the JAX
    CLI shards it over forced host devices. CUDA without a card raises."""
    dev = device(name)
    if dev.type != "cuda":
        return [dev] * n
    out = [torch.device("cuda", i) for i in range(min(n, torch.cuda.device_count()))]
    if len(out) < n:
        print(
            f"[call] WARNING: --mesh {n} requested but only {len(out)} device(s) "
            f"available; using a {len(out)}-device mesh",
            file=sys.stderr,
        )
    return out


def mesh_devices(name, n: int, strict: bool = False) -> list:
    """``n`` devices of type ``name`` for ``augment --mesh``. CUDA: the first
    ``n`` cards; when there are fewer, a warning and a smaller mesh, or with
    ``strict`` (the ``DxK`` form, whose shape cannot shrink) an error that
    names both counts. ``cpu``: the CPU device ``n`` times, a logical mesh
    for tests and rehearsals. CUDA without a card raises."""
    dev = device(name)
    if dev.type != "cuda":
        return [dev] * n
    have = torch.cuda.device_count()
    if have < n:
        if strict:
            raise RuntimeError(
                f"the mesh needs {n} CUDA devices but only {have} are available"
            )
        print(
            f"[augment] WARNING: --mesh {n} requested but only {have} device(s) "
            f"available; using a {have}-device mesh",
            file=sys.stderr,
        )
    return [torch.device("cuda", i) for i in range(min(n, have))]


def card_label() -> str:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` reports them,
    printed beside every measured number (a card capped below its maximum
    power runs slower under load)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip().splitlines()[0]
