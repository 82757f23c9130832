"""The tile blend's kernels and the backward's per-gaussian sum of one or
more checkouts, timed on one card in the order given, at the main path's
shapes (`chip_smoke.py` phase 3: 100k splats, SH3, 800x800, 4 views, 19
channels):

    python -m gsattack_torch.scripts.blend_ab ROOT [ROOT ...] [--reps 20]
        [--rounds 5] [--out FILE]

Each ROOT is a checkout holding `gsattack_torch/`, for example a commit
unpacked by `git archive <commit> gsattack_torch | tar -x -C build/ab/<name>`
into a directory that `.gitignore` lists. Each ROOT runs in a process of its
own, which imports `gsattack_torch` from ROOT (and this checkout's
`chip_smoke.py` for the inputs), builds ROOT's kernels and prints ptxas's
report for the blend kernels and `gather_sum_rows` (registers, shared
memory, spills, and the CTAs an SM can hold by those), holds both blend
kernels against the plain version with the gates of `chip_smoke.py` (at
these shapes, and on phase 2b's batch-edge and cap tiles), and times each
as the mean over `--reps` launches between CUDA events, `--rounds` times,
and the whole backward as autograd runs it (`blend_bwd` and, where ROOT's
backward writes per-pair rows, `gather_sum_rows`). Where it does, the sum
is also held to its plain version (`torch.equal`, on phase 3's table, on
`chip_smoke.gather_sum_edges` and on the wide table) and timed alone, on
phase 3's slot table and on the wide one that phase 11c's trainer bins at
its `auto_caps` (`chip_smoke.trainer_slot_table`, 110,000 x 2500). To
compare two commits, give them in turns, parent, change, change, parent. The summary gives each
ROOT's median over all its rounds; `--out` writes every run as JSON. Exits
1 if any ROOT fails its build or a gate.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TAG = "BLEND_AB "
REGS_PER_SM, SMEM_PER_SM, THREADS = 65536, 233472, 256


def ptxas_report(text: str) -> dict:
    """Per blend kernel instantiation (`fwd<19>`, ...) and per
    instantiation of the per-gaussian sum (`gather_sum_rows<2>`, ...; an
    older checkout's names parse alike): registers, static shared memory,
    stack frame and spill bytes, and the CTAs of 256 threads an SM can
    hold by registers (allocated per warp in units of 256) and by shared
    memory (with the 1 KB the runtime reserves per CTA)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '.*?(?:blend_(fwd|bwd)|"
                      r"(gather_sum_[a-z]+))_kernel(?:ILi(\d+)E)?", line)
        if m:
            kernel = m.group(1) or m.group(2)
            name = f"{kernel}<{m.group(3)}>" if m.group(3) else kernel
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["stack_bytes"] = int(m.group(1))
            out[name]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            regs, smem = int(m.group(1)), int(m.group(2) or 0)
            per_warp = -(-regs * 32 // 256) * 256
            by_regs = (REGS_PER_SM // per_warp) // (THREADS // 32)
            by_smem = SMEM_PER_SM // (smem + 1024)
            out[name].update(registers=regs, smem_bytes=smem,
                             ctas_per_sm=min(by_regs, by_smem, 2048 // THREADS))
            name = None
    return out


def worker(root: str, reps: int, rounds: int) -> dict:
    """One ROOT, in this process: build, check, time."""
    sys.path.insert(0, str(Path(root).resolve()))
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    import gsattack_torch
    from gsattack_torch.ops import _cuda, blend
    from gsattack_torch.ops.raster import _tiles

    if not Path(gsattack_torch.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"gsattack_torch came from {gsattack_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the A/B times kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        _cuda.build(verbose=True)
    build_s = time.perf_counter() - t0

    scene, _, cams, pairs = smoke.main_shapes(device)
    _, _, bins, blend_in = smoke.blend_inputs(scene, cams, pairs, grad_scene=False)
    tiles = _tiles(cams.width, cams.height)
    cap = smoke.CHUNK * smoke.MAX_CHUNKS
    idx = (bins.gauss_idx, bins.tile_start, bins.tile_end)
    cmp = smoke.kernels_vs_plain(idx, blend_in, tiles, cap)
    ok = cmp["fwd_err"] <= smoke.GATE_IMAGE and max(cmp["bwd_rel"].values()) <= smoke.GATE_GRAD
    rows, table = cmp["rows"], cmp["slot_table"]
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            smoke.phase_edge_tiles(device)  # batch edges and the cap, CH = 3 and 19
            if rows is not None:
                smoke.gather_sum_edges(device)
        except AssertionError as e:
            print(f"{root}: {e}", file=sys.stderr)
            ok = False
    plain_in = [x.detach() for x in blend_in]
    T, last, g_img, g_t = cmp["T"], cmp["last"], cmp["g_img"], cmp["g_T"]
    fwd_ms, bwd_ms, grad_ms, sum_ms, wide_ms = [], [], [], [], []
    with torch.no_grad():
        if rows is not None:
            from gsattack_torch.ops.gather_sum import gather_sum_rows, gather_sum_rows_plain

            exts, _, _, init, _ = smoke.train_init(device)
            wide, wide_rows = smoke.trainer_slot_table(init, exts[0], device)
            del init
            if not (torch.equal(gather_sum_rows(rows, table), gather_sum_rows_plain(rows, table))
                    and torch.equal(gather_sum_rows(wide_rows, wide),
                                    gather_sum_rows_plain(wide_rows, wide))):
                print(f"{root}: gather_sum_rows differs from its plain version", file=sys.stderr)
                ok = False
        for _ in range(rounds):
            fwd_ms.append(smoke.cuda_ms(
                lambda: blend.forward_kernel(*idx, *plain_in, *tiles, cap), reps))
            bwd_ms.append(smoke.cuda_ms(
                lambda: blend.backward_kernel(*idx, *plain_in, *tiles, T, last, g_img, g_t), reps))
            # The whole backward: with per-pair rows, blend_bwd and the sum.
            grad_ms.append(smoke.cuda_ms(
                lambda: smoke.kernel_grads(idx, plain_in, tiles, T, last, g_img, g_t, table),
                reps))
            if rows is not None:
                sum_ms.append(smoke.cuda_ms(lambda: gather_sum_rows(rows, table), reps))
                wide_ms.append(smoke.cuda_ms(lambda: gather_sum_rows(wide_rows, wide), reps))
    return {
        "root": root, "ok": ok, "card": smoke.nvidia_smi(), "build_s": build_s,
        "ptxas": ptxas_report(buf.getvalue()), "n_pairs": int(bins.gauss_idx.shape[0]),
        "fwd_err": cmp["fwd_err"], "bwd_rel": cmp["bwd_rel"],
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "grad_ms": grad_ms, "sum_ms": sum_ms,
        "wide_ms": wide_ms, "wide_table": list(wide.shape) if rows is not None else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=20, help="launches per timed round")
    ap.add_argument("--rounds", type=int, default=5, help="timed rounds per kernel")
    ap.add_argument("--out", help="write every run as JSON here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(TAG + json.dumps(worker(args.worker, args.reps, args.rounds)), flush=True)
        return 0
    if not args.roots:
        ap.error("give at least one ROOT")

    runs, failed = [], []
    for i, root in enumerate(args.roots):
        cmd = [sys.executable, __file__, "--worker", root, "--reps", str(args.reps),
               "--rounds", str(args.rounds)]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith(TAG)), None)
        if proc.returncode != 0 or line is None:
            print(f"run {i + 1} {root}: failed ({proc.returncode})\n{proc.stderr[-4000:]}",
                  flush=True)
            failed.append(root)
            continue
        run = json.loads(line[len(TAG):])
        runs.append(run)
        print(f"run {i + 1} {root} ({run['card']}; build {run['build_s']:.1f} s): "
              f"{'ok' if run['ok'] else 'GATE FAILED'}, image/T max abs {run['fwd_err']:.3e}, "
              f"gradients max rel {max(run['bwd_rel'].values()):.3e}; "
              f"fwd ms {' '.join(f'{t:.4f}' for t in run['fwd_ms'])}; "
              f"bwd ms {' '.join(f'{t:.4f}' for t in run['bwd_ms'])}; "
              f"whole backward ms {' '.join(f'{t:.4f}' for t in run['grad_ms'])}; "
              f"gather_sum_rows ms {' '.join(f'{t:.4f}' for t in run['sum_ms'])}; "
              f"on the wide table {' '.join(f'{t:.4f}' for t in run['wide_ms'])}", flush=True)
        for name, rep in sorted(run["ptxas"].items()):
            print(f"  {name}: {rep}", flush=True)
        if not run["ok"]:
            failed.append(root)

    print(f"medians over each ROOT's runs ({args.rounds} rounds of {args.reps} launches each):")
    for root in dict.fromkeys(r["root"] for r in runs):
        mine = [r for r in runs if r["root"] == root]
        fwd = statistics.median(t for r in mine for t in r["fwd_ms"])
        bwd = statistics.median(t for r in mine for t in r["bwd_ms"])
        grad = statistics.median(t for r in mine for t in r["grad_ms"])
        sums = [t for r in mine for t in r["sum_ms"]]
        wides = [t for r in mine for t in r["wide_ms"]]
        alone = (f", gather_sum_rows {statistics.median(sums):.4f} ms, on the "
                 f"{tuple(mine[0]['wide_table'])} table {statistics.median(wides):.4f} ms"
                 if sums else "")
        print(f"  {root}: blend_fwd {fwd:.4f} ms, blend_bwd {bwd:.4f} ms, the whole backward "
              f"{grad:.4f} ms{alone} ({len(mine)} runs)")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
