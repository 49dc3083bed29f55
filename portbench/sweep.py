"""Runs cells several times, each run a process of its own as the driver
runs it, and reports each metric's spread. For measuring bounds and the
check's readings; the benchmark's own runs never call it.

    python3 portbench/sweep.py --out chiprun_out/x.jsonl \
        --runs cornell-frames-1080p-40spp:0:40:1001,1002,1003 ...

Each ``--runs`` item is ``cell:trace:seconds:seed,seed,...``. Every run's
result line (or its failure and the end of its stderr) is appended to the
output file as JSON; a summary of medians and spreads goes to stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    """(median, interquartile distance over the median) by
    ``statistics.quantiles(values, n=4)``."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q = statistics.quantiles(values, n=4)
    return med, (q[2] - q[0]) / abs(med)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--runs", nargs="+", required=True)
    p.add_argument("--timeout", type=float, default=1200)
    a = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    summary = {}
    for item in a.runs:
        cell, trace, seconds, seeds = item.split(":")
        for seed in seeds.split(","):
            cmd = [sys.executable, os.path.join(ROOT, "portbench", "run.py"), "--workload", cell,
                   "--seed", seed, "--seconds", seconds, "--trace", trace]
            t = time.time()
            try:
                r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                                   timeout=a.timeout)
                rc, out, err = r.returncode, r.stdout, r.stderr
            except subprocess.TimeoutExpired as e:
                rc, out, err = 124, e.stdout or "", e.stderr or ""
                out = out.decode() if isinstance(out, bytes) else out
                err = err.decode() if isinstance(err, bytes) else err
            rec = dict(cell=cell, trace=int(trace), seconds=float(seconds), seed=int(seed), rc=rc,
                       wall_s=time.time() - t)
            try:
                rec["result"] = json.loads(out.strip().splitlines()[-1])
            except (IndexError, ValueError):
                rec["stderr_tail"] = err[-4000:]
            rec["stderr_check"] = [ln for ln in err.splitlines() if ln.startswith(("check ", "card", "info "))]
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            res = rec.get("result")
            line = f"{cell} trace={trace} seed={seed} rc={rc} wall={rec['wall_s']:.1f}s"
            if res:
                line += f" correct={res['correct']} " + " ".join(
                    f"{k}={v['value']:.6g}" for k, v in res["metrics"].items())
                line += " | " + " ".join(f"{k}={v['value']:.3g}/{v['limit']:.3g}"
                                         for k, v in res.get("check", {}).items())
                for k, v in res["metrics"].items():
                    summary.setdefault((cell, trace, k), []).append(v["value"])
            else:
                line += " NO RESULT: " + rec["stderr_tail"][-1500:]
            print(line, flush=True)
    for (cell, trace, k), vals in summary.items():
        med, sp = spread(vals)
        print(f"summary {cell} trace={trace} {k}: n={len(vals)} median={med:.6g} "
              f"spread={sp:.4%} values={[round(v, 6) for v in vals]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
