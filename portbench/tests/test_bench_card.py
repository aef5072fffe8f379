"""On the chip, at each cell's own size: the control (the fp32 reference
put in the program's place in fp8) fails the cell's limits while the
program passes them, on three seeds. Run on a card:

    python3 -m pytest portbench/tests -m card -s
"""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (2**31 + 1001, 2**31 + 1002, 2**31 + 1003)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["actionmesh.video16", "actionmesh_fast.mesh16",
                                  "actionmesh_fast.video31"])
def test_control_fails_program_passes(card, cell):
    import json

    from portbench.bench import control

    for r in control.readings(ROOT, cell, SEEDS):
        print(json.dumps(r))
        assert r["correct"], r["program"]
        assert control.control_fails(r), r["control"]
