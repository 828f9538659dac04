#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload ct128_int8.frame8 --seed 7 \\
        --seconds 50 --trace 0

From the root of a checkout.  Builds the port's kernels on the first run in
a checkout (they are cached inside it), sets up the cell's configuration,
warms up its request shape, serves requests for ``--seconds`` in a closed
loop, checks every answer against the plain reference, and prints one JSON
object as the last line of standard output.  ``--trace 1`` reports the
cell's per-layer metrics from a profiler trace instead of its end-to-end
metrics.  Needs the CUDA cards the cell asks for; exits non-zero, with no
result, without them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gpubench.lib import env  # noqa: E402

env.fix_caches()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from gpubench.lib import runner, spec

    cell = spec.load_cell(args.workload)
    env.require_cards(cell["chips"])
    import torch

    torch.cuda.set_device(0)
    facts = env.card_facts(cell["chips"])
    runner.stderr(f"card: {facts['kind']}, power limit "
                   f"{facts['power_limit']}")
    result, judged = runner.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
        log=runner.stderr)
    found = env.forbidden_modules()
    if found:
        sys.exit(f"gpubench: the run loaded {', '.join(found)}; no result")
    line = runner.result_line(result, judged, facts["kind"], cell["chips"])
    for name, c in judged.items():
        runner.stderr(f"check {name} {c['value']!r} limit {c['limit']!r} "
                       f"{'ok' if c['ok'] else 'FAILED'}")
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
