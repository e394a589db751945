#!/usr/bin/env python3
"""Run one cell several times, one process a run, and summarise the spread.

    python3 perfbench/tools/series.py --workload NAME --seeds 11,12,13 \
        --seconds 30 [--trace 0|1] [--control 0|1] [--out runs/NAME.jsonl]

Each run is `python3 perfbench/run.py ...`; its result line, its exit code,
its wall time and the end of its standard error go to one JSON line of
--out. The summary gives, for each metric, the median and the spread (the
distance between the first and third quartiles of Python's
`statistics.quantiles(values, n=4)`, as a share of the median), and the
checks of each run.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args()
    runs = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        if args.control:
            cmd += ["--control", "1"]
        t0 = time.time()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as exc:
            rc, out, err = 124, exc.stdout or "", exc.stderr or ""
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        wall = time.time() - t0
        result = None
        lines = [ln for ln in out.splitlines() if ln.strip()]
        if rc == 0 and lines:
            try:
                result = json.loads(lines[-1])
            except ValueError:
                result = None
        rec = {"workload": args.workload, "seed": seed, "seconds": args.seconds,
               "trace": args.trace, "control": args.control, "rc": rc, "wall_s": wall,
               "result": result, "stderr_tail": err[-3000:]}
        runs.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
        brief = {k: round(v["value"], 6) for k, v in (result or {}).get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in (result or {}).get("checks", {}).items()}
        print(f"seed {seed}: rc {rc}, wall {wall:.1f} s, correct "
              f"{(result or {}).get('correct')}, attempted {(result or {}).get('attempted')}, "
              f"{brief}, checks {checks}", flush=True)
        if rc != 0 or result is None:
            print(err[-2500:], flush=True)
    names = sorted({k for r in runs for k in ((r["result"] or {}).get("metrics") or {})})
    for name in names:
        vals = [r["result"]["metrics"][name]["value"] for r in runs
                if r["result"] and name in r["result"]["metrics"]]
        s = spread(vals)
        print(f"{name}: n {len(vals)}, median {statistics.median(vals):.6g}, "
              f"spread {'-' if s is None else f'{100 * s:.3f} %'}, values "
              f"{[round(v, 6) for v in vals]}", flush=True)


if __name__ == "__main__":
    main()
