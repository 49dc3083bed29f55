"""The check's control: the plain reference computed one precision below
the configuration's (bfloat16 for float32) put in the program's place, at
a cell's own size, judged by the cell's check. Every seed has to come out
not correct. Run on the chip:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--units N]

``--units``: frames (render cells; as many as a run's window holds) or
compared steps (training cells; the traffic's ``check_steps``). ``--fault
half|altered`` (training cells): the check's reading of that fault, planted
in the float64 reference put in the program's place.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import core  # noqa: E402

LOWER = {"float32": "bfloat16", "float64": "float32"}


def control(cell: str, seed: int, units: int | None, device: str = "cuda",
            traffic_override: dict | None = None, fault: str | None = None) -> dict:
    import torch

    bench = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w = {x["name"]: x for x in bench["workloads"]}[cell]
    cfg_file = {c["name"]: c for c in bench["configs"]}[w["config"]]["file"]
    config = core.load_json(os.path.join(ROOT, cfg_file))
    traffic = core.load_json(os.path.join(core.HERE, "traffic", w["traffic"] + ".json"))
    traffic.update(traffic_override or {})
    limits = core.load_json(os.path.join(core.HERE, "limits", cell + ".json"))
    ctx = core.Ctx(cell, config, traffic, seed, 0, device)
    job = core.load_module(os.path.join(core.HERE, "jobs", traffic["kind"] + ".py"), "ctl_job")
    dtype = getattr(torch, LOWER[config["dtype"]])
    n = units if units is not None else traffic.get("check_steps", 1)
    nums = job.control(ctx, n, dtype, fault)
    fails = {k: v > limits[k] for k, v in nums.items()}
    return dict(cell=cell, seed=seed, units=n, fault=fault,
                dtype=str(dtype) if fault is None else "float64 with the fault",
                numbers=nums, limits=limits, fails=fails, not_correct=any(fails.values()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--units", type=int)
    p.add_argument("--fault", choices=("half", "altered", "none"), default="none",
                   help="a training cell: the float64 reference with this fault planted, "
                        "in place of the lower precision")
    a = p.parse_args(argv)
    for seed in a.seeds.split(","):
        t = time.time()
        r = control(a.workload, int(seed), a.units, fault=None if a.fault == "none" else a.fault)
        r["seconds"] = time.time() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
