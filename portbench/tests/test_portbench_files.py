"""BENCHMARK.json and the files it names: found by name, within the
contract's limits, and nothing the benchmark runs imports JAX or the JAX
package."""

import ast
import json
import math
import os
import re

import pytest

from portbench import core

ROOT = core.ROOT
HERE = core.HERE
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    cfg = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert cfg["file"].startswith("portbench/configs/")
    config = core.load_json(os.path.join(ROOT, cfg["file"]))
    traffic = core.load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    assert os.path.exists(os.path.join(HERE, "jobs", traffic["kind"] + ".py"))
    limits = core.load_json(os.path.join(HERE, "limits", cell + ".json"))
    assert limits and all(v >= 0 for v in limits.values())
    assert config["reference"]["camera"]
    e2e = core.cell_metrics(BENCH, cell, "end_to_end")
    assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2
    assert core.cell_metrics(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_module_and_moves(metric):
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    mod = core.load_module(os.path.join(HERE, "metrics", metric + ".py"), "t_" + metric)
    assert callable(mod.install) and callable(mod.value)
    for cell in m["workloads"]:
        reported = {x["name"] for x in core.cell_metrics(BENCH, cell, "end_to_end")}
        assert m["moves"] in reported, (metric, cell)
    if m["unit"] == "%" and ("roofline" in metric or "mfu" in metric):
        assert m["better"] == "higher"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_imports(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(core.FORBIDDEN), (path, tops)
    if os.sep + "reference" + os.sep in path:
        assert "pt_three_ways_tpu_torch" not in tops, path


def test_run_seconds_fit_the_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    full = (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200
    assert full <= 43200
    assert math.floor(0.25 * len(CELLS)) >= sum(w["chips"] == 4 for w in BENCH["workloads"])
