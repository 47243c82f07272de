"""Readings that the limits of ``correct`` are set from: for each seed, a
run of the cell (set-up, a short window at the cell's own load, the
sampled units) and its numbers for the program, for the control (the
reference computed in bfloat16 and judged in the program's place) and for
the reference in float64 (the scale of float32 rounding). One process
for all the seeds; one JSON line a seed.

    python3 port_bench/control.py --workload <name> --seeds 1,2,3 \\
        --seconds 5

The benchmark's own runs do not run this.
"""

import argparse
import importlib
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402


def readings(spec, seed: int, seconds: float, device: str = "cuda"):
    """``(program, control, float64)`` readings of one run of ``spec``:
    the program, the bfloat16 control and, for the scale of float32
    rounding, the reference in float64, each judged against the float32
    reference."""
    import torch

    traffic = spec["traffic"]
    driver = importlib.import_module("port_bench.drivers."
                                     + traffic["driver"])
    cell = driver.Cell(spec["config"], traffic, seed, device)
    cell.warm_up()
    cell.plan(random.Random(seed))
    t0 = time.perf_counter()
    it = cell.units()
    for _, t_done in it:
        if t_done - t0 >= seconds:
            break
    it.close()
    if device != "cpu":
        torch.cuda.synchronize()
    cell.free()
    return (cell.check(), cell.check(control=torch.bfloat16),
            cell.check(control=torch.float64))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        prog, ctrl, f64 = readings(spec, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": prog, "control": ctrl, "float64": f64,
                          "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
