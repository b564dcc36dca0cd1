"""Where the time of the grouped GEMM (``csrc/grouped_gemm.cu``) goes: the
kernel timed whole and with one part taken out at a time, on the card.

    python3 src/repro_torch/kernels/diag_grouped_parts.py

Builds ``csrc/grouped_gemm.cu`` as it is and copies with one part replaced
by a cheap stand-in (the outputs are then wrong, and only timed): the
wgmma products, the TMA loads of W (the producer arrives on the stage's
barrier instead), the TMA loads of x, the epilogue's stores, the loads and
the products together (what is left is the rings' handshakes), and every
tile (what is left is the launch and the set-up).  Each goes
into ``build/diag/`` with nvcc and is timed through its C entry at
qwen2-moe-a2.7b's up shape (K 2048, N 1408, 64 experts): decode (16 rows
on 16 experts, 16 on one), prefill (8,192 rows of a routing with ~136
rows an expert) and a skew (8,192 rows on one expert): device time per
call from torch.profiler, the median of CUDA-event times beside it, and
nvidia-smi's name and power limit.  Needs a card and nvcc; prints
``[diag_grouped]`` lines.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
SRC = os.path.join(CSRC, "grouped_gemm.cu")
# part taken out -> (text of csrc/grouped_gemm.cu, its stand-in)
CUTS = {
    "whole kernel": [],
    "without the wgmma": [
        ("          hopper::wgmma_m64n128k16_bf16_ss_tnspb(\n"
         "              acc, hopper::desc_sw128(xa + kk * 32, 16, 1024),\n"
         "              hopper::desc_sw128(wa + kk * 16 * 128, kBox, 1024), 1);",
         "          acc[kk] += static_cast<float>(xa ^ wa);")],
    "without the W loads": [
        ("hopper::mbar_expect_tx(&wfull[s], wboxes * kBox);",
         "hopper::mbar_arrive(&wfull[s]);"),
        ("hopper::tma_load_3d(", "if (wboxes < 0) hopper::tma_load_3d(")],
    "without the x loads": [
        ("hopper::mbar_expect_tx(&xfull[b], kBox);",
         "hopper::mbar_arrive(&xfull[b]);"),
        ("hopper::tma_load_2d(", "if (b < 0) hopper::tma_load_2d(")],
    "without the stores": [
        ("if (row < rt.end) {", "if (row < rt.end && acc[0] == 12345.f) {")],
}
# what is left with the loads and the products both out: the handshakes
CUTS["without the loads and the wgmma"] = (CUTS["without the W loads"]
                                           + CUTS["without the x loads"]
                                           + CUTS["without the wgmma"])
CUTS["the set-up alone (no tiles)"] = [
    ("const int tiles = count_row_tiles(gs, E, R) * col_tiles;",
     "const int tiles = count_row_tiles(gs, E, R) * col_tiles * (R < 0);")]
K, N, E = 2048, 1408, 64


def _build() -> dict:
    from repro_torch.kernels import build

    out = os.path.join(ROOT, "build", "diag")
    os.makedirs(out, exist_ok=True)
    text = open(SRC).read()
    procs = {}
    for i, (name, reps) in enumerate(CUTS.items()):
        src = text
        for old, new in reps:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in {SRC}")
            src = src.replace(old, new)
        cu, lib = (os.path.join(out, f"grouped_parts_{i}{ext}")
                   for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", CSRC, "-shared",
             "-o", lib, cu, "-lcudart"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(lib).repro_grouped_gemm
        fn.argtypes = build.SIGNATURES["repro_grouped_gemm"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _times(torch, fn) -> tuple[float, float]:
    """(device ms per call under torch.profiler, median event ms)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ev.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    dev = sum(getattr(e, "self_device_time_total", 0.0)
              for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return dev / 1e3 / 10, statistics.median(ev)


def _sizes(torch, case: str):
    sizes = torch.zeros(E, dtype=torch.int32)
    if case == "decode, 16 rows on 16 experts":
        sizes[torch.randperm(60, generator=torch.Generator().manual_seed(3))
              [:16]] = 1
    elif case == "decode, 16 rows on one expert":
        sizes[17] = 16
    elif case == "prefill, 8,192 rows (~136 an expert)":
        sizes[:60] = torch.distributions.Multinomial(
            8192, torch.ones(60)).sample().int()
    else:
        sizes[42] = 8192
    return sizes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("diag_grouped_parts: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    libs = _build()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = (torch.randn((E, K, N), generator=gen, device=dev)
         * K ** -0.5).to(torch.bfloat16)
    stream = build.stream_handle(dev)
    for case in ("decode, 16 rows on 16 experts",
                 "decode, 16 rows on one expert",
                 "prefill, 8,192 rows (~136 an expert)",
                 "skew, 8,192 rows on one expert"):
        sizes = _sizes(torch, case)
        r = int(sizes.sum())
        gs = sizes.to(dev)
        x = torch.randn((r, K), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((r, N), dtype=torch.bfloat16, device=dev)
        for name, fn in libs.items():
            def call(fn=fn):
                status = fn(x.data_ptr(), w.data_ptr(), gs.data_ptr(),
                            out.data_ptr(), r, K, N, E, stream)
                if status != 0:
                    raise RuntimeError(f"{name}: launch failed ({status})")
            dev_ms, ev_ms = _times(torch, call)
            print(f"[diag_grouped] {case}, K={K} N={N}, {name}: device "
                  f"{dev_ms:.4f} ms, events {ev_ms:.4f} ms on {smi}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
