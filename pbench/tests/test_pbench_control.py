"""The control (the reference in the program's place, counts held in
float16) comes out not correct in the cell, on three seeds, at a depth
where the busiest slots pass float16's stop; on the card it runs at the
cells' own size (``python3 -m pbench.control``)."""

from __future__ import annotations

import json

from pbench import control


def test_control_is_not_correct(deep_root, capsys):
    rc = control.main(["--workload", "augment-dmreal10-skew", "--seeds", "1", "2", "3"], root=deep_root)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rc == 0 and len(lines) == 3
    for line in lines:
        assert line["correct"] is False
        assert any(c["value"] > c["limit"] for c in line["checks"].values())
