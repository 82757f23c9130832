"""Micro-bench of the row gather on one card: the CUDA kernel of
`gsattack_torch/ops/gather.py` against the library gather
(`torch.index_select`), at the sizes of the 500k-splat scene's gathers
(a source of ~1.8M rows of W floats, ~2.2M indices). The counterpart of the
JAX package's `scripts/micro_gather.py`, with its four modes:

    python -m gsattack_torch.scripts.micro_gather [main] [--s 1787904] [--m 2217984]
        [--w 16] [--threads 128,256,512] [--in-flight 1,2,4,8] [--iters 4]
    python -m gsattack_torch.scripts.micro_gather sweep [--sizes 50000,...]
    python -m gsattack_torch.scripts.micro_gather sweep_w [--widths 8,16,24,32,48]
    python -m gsattack_torch.scripts.micro_gather sweep_split

  main         the kernel at each launch setting (threads per CTA x loads in
               flight per thread) beside `index_select`;
  sweep        ns/row against the number of source rows at fixed M and W;
  sweep_w      row widths, each from a direct (S, W) source, a transposed
               (W, S) one, and split into two half-width gathers;
  sweep_split  the high 16 columns of a W = 32 gather from a column slice, a
               transposed field-major source and a compact copy, with and
               without the output transposed.

Where the kernel applies (a contiguous (S, W) source) its time stands beside
the library's. Each call is timed on the device by its own pair of CUDA
events, after a warm-up, with the L2 cache flushed before it and the host's
dispatch hidden behind a spin kernel; the line gives the mean ms and ns per
gathered row. Data is made on the device from `--seed`. Every result is
compared with `index_select`'s by `torch.equal` (a gather is exact); the
script exits 1 after any mismatch.

It runs on the card unless `--device cpu` is passed. On the CPU the kernel's
route is its plain version and nothing is timed: a dry run of the checks, at
tiny sizes.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from gsattack_torch.device import resolve_device
from gsattack_torch.ops import gather

MODES = ("main", "sweep", "sweep_w", "sweep_split")
SPIN_CYCLES = 2_000_000  # about 1 ms of an H100's clock
HBM_BYTES_S = 3.35e12  # an H100 SXM's HBM3 rate, the gather's bound


def moved_bytes(m: int, w: int, distinct: int) -> int:
    """Bytes a gather of m rows of w floats, `distinct` of them different
    rows of the source, must move: each int32 index read once, each distinct
    source row read once and each output row written once."""
    return 4 * m + 4 * w * distinct + 4 * m * w


def distinct_rows(idx: torch.Tensor) -> int:
    """The number of different source rows `idx` names."""
    return int(torch.unique(idx).numel())


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0]


class Bench:
    """Times device work and checks results against the library's."""

    def __init__(self, device: torch.device, iters: int, seed: int):
        self.device = device
        self.iters = iters
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.mismatches: list[str] = []
        self.flush = None
        if device.type == "cuda":
            l2 = getattr(torch.cuda.get_device_properties(device), "L2_cache_size", 50 << 20)
            self.flush = torch.empty(2 * l2 // 4, dtype=torch.float32, device=device)

    def table(self, rows: int, w: int) -> torch.Tensor:
        return torch.randn((rows, w), generator=self.gen, device=self.device)

    def indices(self, s: int, m: int) -> torch.Tensor:
        return torch.randint(0, s, (m,), generator=self.gen, device=self.device,
                             dtype=torch.int32)

    def ms(self, fn) -> float | None:
        """Mean device ms of fn() over `iters` calls, each between its own
        two CUDA events, L2 flushed before each; None on the CPU. A ~1 ms
        spin kernel ahead of each start event keeps the card busy while the
        host dispatches fn(), so the events time the device's work and not
        the host's launch path."""
        if self.device.type != "cuda":
            fn()
            return None
        fn()
        torch.cuda.synchronize(self.device)
        pairs = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize(self.device)
        return sum(s.elapsed_time(e) for s, e in pairs) / self.iters

    def check(self, tag: str, got: torch.Tensor, want: torch.Tensor) -> None:
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=-1).sum()) if got.shape == want.shape else -1
            print(f"  !! {tag} MISMATCH with index_select ({bad} rows differ; "
                  f"shapes {tuple(got.shape)} / {tuple(want.shape)})", flush=True)
            self.mismatches.append(tag)

    def run(self, tag: str, fn, want: torch.Tensor | None, m: int) -> float | None:
        """Check fn()'s result against `want` (when given), time it, print
        one line and return its ms."""
        if want is not None:
            self.check(tag, fn(), want)
        ms = self.ms(fn)
        if ms is None:
            print(f"{tag:28s} not timed (cpu dry run)", flush=True)
        else:
            print(f"{tag:28s} {ms:9.4f} ms ({ms * 1e6 / m:7.3f} ns/row)", flush=True)
        return ms


def library(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(src, 0, idx)


def run_main(b: Bench, args) -> None:
    s, m, w = args.s, args.m, args.w
    src, idx = b.table(s, w), b.indices(s, m)
    ref = library(src, idx)
    distinct = distinct_rows(idx)
    nbytes = moved_bytes(m, w, distinct)
    print(f"S={s} M={m} W={w} ({s * w * 4 / 1e6:.1f} MB source, {distinct} distinct rows, "
          f"{nbytes} B moved: bound {nbytes / HBM_BYTES_S * 1e3:.4f} ms at "
          f"{HBM_BYTES_S / 1e12} TB/s)", flush=True)
    b.run("index_select", lambda: library(src, idx), None, m)
    for threads in map(int, args.threads.split(",")):
        for in_flight in map(int, args.in_flight.split(",")):
            b.run(f"kernel_t{threads}_f{in_flight}",
                  lambda: gather.gather_rows(src, idx, threads=threads, in_flight=in_flight),
                  ref, m)


def sweep(b: Bench, args) -> None:
    m, w = args.m, args.w
    for s in map(int, args.sizes.split(",")):
        src, idx = b.table(s, w), b.indices(s, m)
        ref = library(src, idx)
        print(f"S={s:9d} ({s * w * 4 / 1e6:7.1f} MB source), M={m}, W={w}", flush=True)
        b.run("  index_select", lambda: library(src, idx), None, m)
        b.run("  kernel", lambda: gather.gather_rows(src, idx), ref, m)


def sweep_w(b: Bench, args) -> None:
    s, m = args.s, args.m
    idx = b.indices(s, m)
    for w in map(int, args.widths.split(",")):
        src = b.table(s, w)
        ref = library(src, idx)
        src_t = src.t().contiguous()  # (W, S): rows of the source are its columns
        print(f"W={w} (S={s}, M={m})", flush=True)
        b.run(f"direct_w{w} index_select", lambda: library(src, idx), None, m)
        b.run(f"direct_w{w} kernel", lambda: gather.gather_rows(src, idx), ref, m)
        b.run(f"fromT_w{w} index_select", lambda: library(src_t.t(), idx), ref, m)
        if w >= 16:
            h = w // 2
            lo, hi = src[:, :h].contiguous(), src[:, h:].contiguous()
            b.run(f"split2_w{w} index_select",
                  lambda: torch.cat([library(lo, idx), library(hi, idx)], 1), ref, m)
            b.run(f"split2_w{w} kernel",
                  lambda: torch.cat([gather.gather_rows(lo, idx), gather.gather_rows(hi, idx)], 1),
                  ref, m)


def sweep_split(b: Bench, args) -> None:
    s, m = args.s, args.m
    idx = b.indices(s, m)
    src = b.table(s, 32)
    fm = src.t().contiguous()  # field-major (32, S)
    hi = src[:, 16:].contiguous()
    ref = library(src, idx)
    ref_lo, ref_hi = ref[:, :16], ref[:, 16:]
    print(f"high 16 columns of a W=32 gather (S={s}, M={m})", flush=True)
    cases = [
        ("slice_lo index_select", lambda: library(src[:, 0:16], idx), ref_lo),
        ("slice_hi index_select", lambda: library(src[:, 16:32], idx), ref_hi),
        ("fmT_hi index_select", lambda: library(fm[16:32].t(), idx), ref_hi),
        ("sep_hi index_select", lambda: library(hi, idx), ref_hi),
        ("sep_hi kernel", lambda: gather.gather_rows(hi, idx), ref_hi),
        ("slice_hi_T index_select", lambda: library(src[:, 16:32], idx).t().contiguous(),
         ref_hi.t()),
        ("sep_hi_T index_select", lambda: library(hi, idx).t().contiguous(), ref_hi.t()),
        ("sep_hi_T kernel", lambda: gather.gather_rows(hi, idx).t().contiguous(), ref_hi.t()),
        ("fmT_hi_T index_select", lambda: library(fm[16:32].t(), idx).t().contiguous(),
         ref_hi.t()),
    ]
    for tag, fn, want in cases:
        b.run(tag, fn, want, m)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m gsattack_torch.scripts.micro_gather",
        description="Row-gather kernel against torch.index_select on one card.",
    )
    ap.add_argument("mode", nargs="?", default="main", choices=MODES)
    ap.add_argument("--s", type=int, default=1_787_904, help="source rows")
    ap.add_argument("--m", type=int, default=2_217_984, help="gathered rows")
    ap.add_argument("--w", type=int, default=16, help="row width (main, sweep)")
    ap.add_argument("--threads", default="128,256,512", help="threads per CTA (main)")
    ap.add_argument("--in-flight", default="1,2,4,8", help="loads in flight per thread (main)")
    ap.add_argument("--sizes", default="50000,100000,200000,300000,400000,600000,"
                    "900000,1400000,1800000", help="source rows (sweep)")
    ap.add_argument("--widths", default="8,16,24,32,48", help="row widths (sweep_w)")
    ap.add_argument("--iters", type=int, default=4, help="timed calls per line")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu for a dry run")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {card_line()} ({torch.cuda.get_device_name(device)}, "
              f"torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    else:
        print(f"device: {device} (dry run: results checked, nothing timed)", flush=True)
    b = Bench(device, args.iters, args.seed)
    {"main": run_main, "sweep": sweep, "sweep_w": sweep_w, "sweep_split": sweep_split}[
        args.mode](b, args)
    if b.mismatches:
        print(f"FAILED: {len(b.mismatches)} results differ from index_select: "
              + ", ".join(b.mismatches), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
