"""The readings that the limits of `correct` are set from, for one cell,
in one process: for each seed, the program's numbers (its first three
steps through the window's call, against the reference), the control's
(the reference computed in the configuration's lower precision, in the
program's place, against the reference in float32), and each planted
fault's (`faults.py`: the program with the fault, against the reference).

    python3 -m portbench.calibrate --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds <n> ...] [--fault-seeds <n> ...] [--out <file.json>]

The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from . import faults, run

# A window that holds the checked steps: DAGGER's first three, training's
# first densify pass (step 100) and opacity reset (step 300) at ~30 steps/s.
WINDOW_S = {"dagger": 3.0, "train": 14.0}


def readings(workload: str, seeds: list, control_seeds: list, fault_seeds: list,
             seconds: float) -> dict:
    import torch

    wl = run.load_json("workloads", f"{workload}.json")
    config = run.load_json("configs", f"{wl['config']}.json")
    driver = importlib.import_module(f"portbench.drivers.{config['kind']}")
    dev = torch.device("cuda", 0)
    # A state left unchanged reads 1 by the change's measure: no run.
    planted = faults.FAULTS[config["kind"]][1:]
    out = {"workload": workload, "device": torch.cuda.get_device_name(dev), "program": {},
           "control": {}, **{f: {} for f in planted}}
    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        t0 = time.perf_counter()
        cell = driver.Cell(config, wl, seed, dev)
        cell.window(seconds)
        cell.release()
        t_ref0 = time.perf_counter()
        ref = cell.reference()
        if seed in seeds:
            out["program"][seed] = {n: v for n, v, _ in cell.numbers(ref)}
        t_ref = time.perf_counter() - t_ref0
        if seed in control_seeds:
            cell.taken = cell.reference(control=True)["record"]
            out["control"][seed] = {n: v for n, v, _ in cell.numbers(ref)}
        if seed in fault_seeds:
            for fault in planted:
                patches = faults.Patches()
                try:
                    faults.plant(config["kind"], fault, patches)
                    broken = driver.Cell(config, wl, seed, dev)
                    broken.window(seconds)
                finally:
                    patches.undo()
                broken.release()
                out[fault][seed] = {n: v for n, v, _ in broken.numbers(ref)}
                del broken
        print(json.dumps({"seed": seed, **{k: out[k].get(seed) for k in
                                           ("program", "control", *planted)},
                          "reference_s": t_ref, "seconds": time.perf_counter() - t0}),
              flush=True)
        del cell, ref
        torch.cuda.empty_cache()
    for side in ("program", "control", *planted):
        vals = list(out[side].values())
        if vals:
            pick = max if side == "program" else min
            out[f"{side}_{pick.__name__}"] = {k: pick(v[k] for v in vals) for k in vals[0]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=None,
                   help="each window's length; by default long enough for the passes checked "
                        f"(by kind: {WINDOW_S})")
    p.add_argument("--out")
    args = p.parse_args(argv)
    run.cache_dirs()
    wl = run.load_json("workloads", f"{args.workload}.json")
    kind = run.load_json("configs", f"{wl['config']}.json")["kind"]
    out = readings(args.workload, args.seeds, args.control_seeds, args.fault_seeds,
                   args.seconds or WINDOW_S[kind])
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({k: v for k, v in out.items() if k.endswith(("_max", "_min"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
