"""Run one cell of the port's benchmark on the CUDA card of this machine.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; its last key, ``checks``, holds
each number compared with its limit, which the last lines of standard
error repeat. Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits with 2; with JAX or the JAX
package loaded once the window has closed, with 3; when every try at the
trace of a ``--trace 1`` run lost a kernel's device record, with 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.cell_spec(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(spec, args.seed, args.seconds,
                               bool(args.trace), "cuda", T_START)
    except harness.IncompleteTrace as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 4
    bad = harness.forbidden_modules()
    if bad:
        print(f"port_bench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
