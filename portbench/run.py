"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `portbench/workloads/<cell>.json` (its configuration's name,
its traffic, the limits of its check); the configuration is
`portbench/configs/<config>.json`, whose `kind` names the driver in
`portbench/drivers/`; each per-layer metric that `BENCHMARK.json` lists for
the cell is read by `portbench/metrics/<metric>.py`. A run sets up (inputs
from the seed, the program's objects, a warm-up of the cell's shapes),
measures for `--seconds` (under `torch.profiler` with `--trace 1`), reads
the device's memory peak, frees the program's state, runs the plain
reference over the same inputs and compares. The last lines on standard
error, and the result's last key, give each number compared beside its
limit; the last line on standard output is the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gsattack")
# The traced part of a `--trace 1` run's window (trace.py's Tracer).
TRACE_S = 30.0


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its CUDA library under build/gsattack_torch)."""
    base = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)
        (base / sub).mkdir(parents=True, exist_ok=True)


def load_json(*parts) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def result_line(correct, res, metrics, device, numbers, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # Strict JSON has no Infinity or NaN: a number that could not be read
    # (a step that never came, a loss that is not finite) is written as the
    # largest float, far over any limit.
    out["checks"] = {name: {"value": value if math.isfinite(value) else 1.7976931348623157e308,
                            "limit": limit} for name, value, limit in numbers}
    return json.dumps(out, allow_nan=False)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    # One host thread for the CPU ops: the loops are host-bound, and a
    # pool of spinning workers on the machine's few cores makes runs spread.
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    workload = load_json("workloads", f"{args.workload}.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"portbench: the cell needs {workload['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    config = load_json("configs", f"{workload['config']}.json")
    return run_cell(args, workload, config, torch.device("cuda", 0))


def run_cell(args, workload: dict, config: dict, device) -> int:
    """Set up, measure, check and print. The harness's own tests call it
    on the CPU at small sizes, where no device number means anything."""
    import torch

    from . import compare, trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    driver = importlib.import_module(f"portbench.drivers.{config['kind']}")
    torch.manual_seed(args.seed % 2 ** 63)
    cell = driver.Cell(config, workload, args.seed, device)
    setup_s = time.perf_counter() - T_START
    tracer = trace.Tracer(TRACE_S, args.seconds) if args.trace else None
    if tracer:
        tracer.begin()
    res = cell.window(args.seconds, on_unit=tracer.unit if tracer else None)
    tr = tracer.finish() if tracer else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cell.release()
    ref = cell.reference()
    numbers = cell.numbers(ref)
    correct = compare.verdict(numbers)
    if args.trace:
        ctx = {"kind": config["kind"], "units": tracer.units, "trace": tr,
               **cell.trace_context(ref)}
        metrics = {}
        for m in bench["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload]):
                continue
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {**device_info(device, peak), "busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": [list(x) for x in tr.device_ops],
                     "idle_gaps": [list(x) for x in tr.idle_gaps]}
    else:
        values = {**cell.end_to_end(res), "setup_s": setup_s}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
        dev, breakdown = device_info(device, peak), None
    # Last, after every reader and the trace's context have run: what they
    # imported is in `sys.modules` too.
    found = forbidden_modules()
    if found:
        print(f"portbench: the run imported {found}", file=sys.stderr)
        return 3
    for name, value, limit in numbers:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(result_line(correct, res, metrics, dev, numbers, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
