"""One short run of each cell on the card, through the command the driver
runs (skips without a card)."""

import json
import os
import subprocess
import sys

import pytest

from portbench import core

CELLS = [w["name"] for w in core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    r = subprocess.run([sys.executable, os.path.join(core.HERE, "run.py"), "--workload", cell,
                        "--seed", "4294967311", "--seconds", "2", "--trace", "0"],
                       cwd=core.ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
