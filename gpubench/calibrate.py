#!/usr/bin/env python3
"""Readings that the limits of a configuration's output checks are set
from, on the card at the cells' own size.

    python3 gpubench/calibrate.py --config ct128_int8 --seeds 12 \\
        --first-seed 1000 [--control-seeds 3] [--out FILE]

In one process: the program's operators in the configuration's storage type
and, as the control, in the next lower type the program has
(``control_dtype``); for each seed the slice pool, every distinct request of
each traffic mix that a cell pairs with this configuration, answered by the
program and by the control, and the float64 reference of every slice.
Prints one JSON line per seed and mix: the compared numbers (``x_gap``,
``res_gap``, ``fit_gap``, ``self_fit_gap``) of the program and of the
control.  The lower reading of a
number is its largest over the program's seeds, the upper its smallest over
the control's.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gpubench.lib import env  # noqa: E402

env.fix_caches()


def readings(cfg, mixes, seeds, control_seeds, device, log):
    import torch

    from gpubench.lib import runner, scanner

    prog = runner.Program(cfg, device)
    ctrl = runner.Program(cfg, device, dtype=cfg["control_dtype"])
    A, B, _ = runner.reference_operators(cfg, device)
    log(f"packing {prog.pack_s:.1f} s, control {ctrl.pack_s:.1f} s")
    for j, seed in enumerate(seeds):
        for mix_name, traffic in mixes.items():
            pool = scanner.slice_pool(cfg, traffic, seed, device)
            ref = runner.reference_answers(cfg, traffic, pool, A, B)
            line = dict(config=cfg["name"], mix=mix_name, seed=seed)
            sides = [("program", prog)]
            if j < control_seeds:
                sides.append(("control", ctrl))
            for side, p in sides:
                request = p.caller(cfg, traffic, pool)
                answers, ms = [], []
                for i in range(scanner.distinct_requests(traffic)):
                    t0 = time.perf_counter()
                    answers.append((i, *request(i)))
                    ms.append((time.perf_counter() - t0) * 1e3)
                line[side] = runner.gaps(answers, ref, traffic)
                line[side]["request_ms_median"] = sorted(ms)[len(ms) // 2]
            yield line
            del pool, ref
            torch.cuda.empty_cache()


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    from gpubench.lib import runner, spec

    bench = spec.benchmark()
    cfg = spec.config(args.config)
    mixes = {w["traffic"]: spec.traffic(w["traffic"])
             for w in bench["workloads"] if w["config"] == args.config}
    env.require_cards(1)
    facts = env.card_facts(1)
    runner.stderr(f"card: {facts['kind']}, power limit "
                   f"{facts['power_limit']}")
    seeds = [args.first_seed + k for k in range(args.seeds)]
    for line in readings(cfg, mixes, seeds, args.control_seeds, "cuda",
                         runner.stderr):
        line["card"] = facts
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as out:
                out.write(json.dumps(line) + "\n")
    found = env.forbidden_modules()
    if found:
        sys.exit(f"calibrate: the process loaded {', '.join(found)}")


if __name__ == "__main__":
    main()
