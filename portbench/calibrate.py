"""The readings that ``check.py``'s limits are set from, on the chip.

For each seed, one run of the cell at its own load with a short window, then
the program's numbers and the control's (the reference in bfloat16) on the
same sampled frames, each frame's numbers on one JSON line:

    python3 -m portbench.calibrate --workload <cell> --seconds 2 --seeds <n> ...

The lower reading of a number is the largest the program gives over the
seeds; the upper is the smallest the control gives. The benchmark's own runs
do not run the control.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import deploy, harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = deploy.load_config(cell["config"], bench)
    traffic = harness.load_traffic(cell["traffic"])
    metrics = {"end_to_end": [], "per_layer": []}
    for seed in args.seeds:
        res = harness.run_cell(cfg, traffic, metrics, seed, args.seconds, False,
                               args.device, harness.process_start(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "frames": res["attempted"],
                          "program": res["check"], "program_per_frame": res["per_frame"],
                          "control": res["control"]["numbers"],
                          "control_per_frame": res["control"]["per_frame"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
