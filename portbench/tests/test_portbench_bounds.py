"""The frozen bound arithmetic gives the bounds PERF.md records from the
proof script's recorded inputs (NVIDIA H100 80GB HBM3, 700 W)."""

import pytest

from portbench import bounds


def test_k4_cornell_tile():
    # the CLI default's main launch: 434,158,300 live bounces on cornell
    # (38 triangles, 1 sphere), N = 6,635,520 lanes, S = 32
    ms, by = bounds.megakernel_one_window(434_158_300, 1, 38, 0)
    assert by == "operations"
    assert ms == pytest.approx(13.511, abs=5e-4)


def test_k8_mean_of_four_bounces():
    # suzanne 512^2 per-pass step: (hit, live miss, dead) lanes by bounce;
    # attribute tables of 970 triangles x 30 and 2 spheres x 12 floats, and
    # the sums (3 materials x 9 + 3 environment floats)
    lanes = [(55953, 33149, 4105202), (100095, 198417, 3895792),
             (316674, 246335, 3631295), (832605, 3361699, 0)]
    tables = (970 * 30 + 2 * 12) * 4
    outs = (3 * 9 + 3) * 4
    ms = [bounds.shading_adjoint(h, m, d, tables, outs) for h, m, d in lanes]
    assert all(by == "bytes" for _, by in ms)
    assert [round(x, 4) for x, _ in ms] == [0.1366, 0.1384, 0.1432, 0.1692]
    assert sum(x for x, _ in ms) / 4 == pytest.approx(0.147, abs=5e-4)
