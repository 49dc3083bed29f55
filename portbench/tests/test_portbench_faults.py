"""The check itself: a run with the timed path broken underneath comes out
not correct, a sound run correct, and the control (the reference in
bfloat16 in the program's place) fails. Runs the harness on the CPU at a
tiny size, past its look for a card."""

import numpy as np
import pytest
import torch

from portbench import control, core

TINY = {
    "cornell-frames-1080p-40spp": {"width": 24, "height": 14, "spp": 2, "check_pixels": 24},
    "suzanne-frames-256-8spp": {"width": 16, "height": 16, "spp": 2, "check_pixels": 24},
    "suzanne-train-512-s1": {"width": 12, "height": 12},
}
SEED = 2 ** 31 + 977


def _run(cell):
    res, _ = core.run_cell(cell, SEED, 0.01, 0, device="cpu", traffic_override=TINY[cell])
    return res


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


def _frames_fault(monkeypatch, kind):
    from pt_three_ways_tpu_torch.models import integrator, render as render_mod

    orig = render_mod.render
    if kind == "unchanged":
        first = {}

        def render(scene, camera, params, **kw):  # every frame returns the first one
            if "out" not in first:
                first["out"] = orig(scene, camera, params, **kw)
            return first["out"]
    elif kind == "half":
        def render(scene, camera, params, **kw):  # half the samples, their mean
            out = orig(scene, camera, params.replace(
                samples_per_pixel=max(params.samples_per_pixel // 2, 1)), **kw)
            scale = params.samples_per_pixel // max(params.samples_per_pixel // 2, 1)
            out.sum *= scale
            out.count *= np.uint64(scale)
            return out
    else:
        trace = integrator.trace_passes_fused

        def altered(*a, **kw):  # the radiance altered where it is produced
            r = trace(*a, **kw)
            return (r[0] * 1.01,) + tuple(r[1:]) if isinstance(r, tuple) else r * 1.01
        monkeypatch.setattr(integrator, "trace_passes_fused", altered)
        return
    monkeypatch.setattr(render_mod, "render", render)


@pytest.mark.parametrize("cell", ["cornell-frames-1080p-40spp", "suzanne-frames-256-8spp"])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_frames_are_not_correct(monkeypatch, cell, kind):
    _frames_fault(monkeypatch, kind)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_steps_are_not_correct(monkeypatch, kind):
    from pt_three_ways_tpu_torch.parallel import train as train_mod

    make = train_mod.make_sharded_train_step
    grads = train_mod._grads

    def broken(*a, **kw):
        step = make(*a, **kw)

        def run(state, key, px, py, target):
            if kind == "unchanged":  # the step returns its state unchanged
                loss, _ = step(state, key, px, py, target)
                return loss, state
            # half of the pixels left out, the mean taken over the rest
            h = px.shape[0] // 2
            return step(state, key, px[:h], py[:h], target[:h])
        return run

    if kind == "altered":  # one gradient altered where it is produced
        monkeypatch.setattr(train_mod, "_grads",
                            lambda r, c, leaves: [g * 1.1 if i == 1 else g
                                                  for i, g in enumerate(grads(r, c, leaves))])
    else:
        monkeypatch.setattr(train_mod, "make_sharded_train_step", broken)
    assert not _run("suzanne-train-512-s1")["correct"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails(cell):
    units = 2 if "frames" in cell else None
    r = control.control(cell, SEED, units, device="cpu", traffic_override=TINY[cell])
    assert r["dtype"] == str(torch.bfloat16)
    assert r["not_correct"], r
