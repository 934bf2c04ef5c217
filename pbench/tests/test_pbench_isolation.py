"""No run loads JAX or the JAX package (top-level names compared whole: the
program's name begins with the JAX package's), and the reference loads
nothing of the program either."""

from __future__ import annotations

import subprocess
import sys

from conftest import REPO

from pbench import run

FOREIGN = ("jax", "jaxlib", "flax", "pantas_tpu")


def test_names_are_compared_whole(monkeypatch):
    for name in ("pantas_tpu_torch", "pantas_tpu_torch.events", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "pantas_tpu", raising=False)
    assert run.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "pantas_tpu.events", sys)
    assert run.foreign_modules() == ["pantas_tpu"]


def _top_names(code: str, cwd) -> set:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                        "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                       cwd=cwd, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program(deep_root):
    code = ("import json\nfrom pathlib import Path\n"
            "from pbench import control\n"
            "control.main(['--workload', 'augment-dmreal10-skew', '--seeds', '4'], root=Path('.'))\n")
    names = _top_names(code, deep_root)
    assert "pbench" in names
    assert names.isdisjoint({"pantas_tpu_torch", *FOREIGN})


def test_a_run_loads_no_jax(tiny_root):
    code = (f"import sys\nsys.path.append({str(REPO)!r})\nfrom pathlib import Path\n"
            "from pbench import run\n"
            "assert run.main(['--workload', 'augment-dmreal10-skew', '--seed', '3', '--seconds',"
            " '0.2', '--trace', '1'], root=Path('.'), device='cpu') == 0\n")
    names = _top_names(code, tiny_root)
    assert "pantas_tpu_torch" in names
    assert names.isdisjoint(FOREIGN)
