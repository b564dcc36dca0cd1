"""Where the time of the bf16 SSD intra-chunk kernel (B6) goes: the kernel
timed whole and with one part taken out at a time, on the card.

    python3 src/repro_torch/kernels/diag_b6_parts.py

Builds ``csrc/ssd_scan.cu`` as it is and four copies, each with one part
replaced by a cheap stand-in (the outputs are then wrong, and only timed):
the exp2 of L, the S x mma.sync, the y stores, and the whole per-head loop
over key tiles (what is left: C B^T, cs, the x copies and storing zeros).
Each goes into ``build/diag/`` with nvcc and is timed through its C entry
at zamba2-7b's and mamba2-130m's prefill shapes (B 4, S 512, Q 128; 112
heads of 64 with N 64, and 24 heads with N 128): device time per call from
torch.profiler, the median of CUDA-event times beside it, and nvidia-smi's
name and power limit.  Needs a card and nvcc; prints ``[diag_b6]`` lines.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                   "ssd_scan.cu")
# part taken out -> (text of csrc/ssd_scan.cu, its stand-in)
CUTS = {
    "whole kernel": [],
    "without exp2": [("s[k] * exp2f(d)", "s[k] * (1.0f + d)")],
    "without the S x mma.sync": [
        ("mma_bf16(acc[2 * np], af[t], xf[np][0], xf[np][1]);",
         "acc[2 * np][0] += __uint_as_float(af[t][0] ^ xf[np][0]);"),
        ("mma_bf16(acc[2 * np + 1], af[t], xf[np][2], xf[np][3]);",
         "acc[2 * np + 1][0] += __uint_as_float(af[t][1] ^ xf[np][2]);")],
    "without the y stores": [
        ("            if (t >= Q) continue;\n",
         "            if (t >= Q || acc[0][0] != 12345.f) continue;\n")],
    "without the key-tile loop": [
        ("for (int kt = 0; kt <= rt; ++kt) {",
         "for (int kt = 0; kt <= rt && acc[0][0] == 12345.f; ++kt) {")],
}
SHAPES = (("zamba2-7b", 4, 512, 112, 1, 64, 64, 128),
          ("mamba2-130m", 4, 512, 24, 1, 64, 128, 128))


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
        cu, lib = (os.path.join(out, f"ssd_parts_{i}{ext}")
                   for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", lib, cu,
             "-lcudart"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        dll = ctypes.CDLL(lib)
        fn = dll.repro_ssd_intra_chunk
        fn.argtypes = build.SIGNATURES["repro_ssd_intra_chunk"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _times(torch, fn, n_bufs: int) -> tuple[float, float]:
    """(device ms per call under torch.profiler, median event ms)."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    ev = []
    for i in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i % n_bufs)
        end.record()
        end.synchronize()
        ev.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(10):
            fn(i % n_bufs)
        torch.cuda.synchronize()
    dev = sum(getattr(e, "self_device_time_total", 0.0)
              for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return dev / 1e3 / 10, statistics.median(ev)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("diag_b6_parts: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan.ops import ctas_per_sm, head_block

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    libs = _build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = build.stream_handle(dev)
    for tag, b, s, h, g, p, n, q in SHAPES:
        bufs = []
        for _ in range(2):   # two input sets, so the 50 MB L2 holds neither
            x = torch.randn((b, s, h, p), generator=gen, device=dev).to(
                torch.bfloat16)
            dt = torch.nn.functional.softplus(
                torch.randn((b, s, h), generator=gen, device=dev))
            a = -torch.linspace(1.0, 16.0, h, device=dev) * dt
            bm, cm = (torch.randn((b, s, g, n), generator=gen, device=dev)
                      .mul(0.5).to(torch.bfloat16) for _ in range(2))
            y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
            st = (ctypes.c_longlong * 12)(*x.stride()[:3], *a.stride(),
                                          *bm.stride()[:3], *cm.stride()[:3])
            bufs.append((x, a, bm, cm, y, st))
        hpc = head_block(b, s // q, h, g, sms * ctas_per_sm(p))
        for name, fn in libs.items():
            def call(i, fn=fn):
                x, a, bm, cm, y, st = bufs[i]
                status = fn(x.data_ptr(), a.data_ptr(), bm.data_ptr(),
                            cm.data_ptr(), y.data_ptr(), b, s, h, g, n, p, q,
                            hpc, 1, st, stream)
                if status != 0:
                    raise RuntimeError(f"{name}: launch failed ({status})")
            dev_ms, ev_ms = _times(torch, call, len(bufs))
            print(f"[diag_b6] {tag} B={b} S={s} H={h} P={p} N={n} Q={q} "
                  f"({hpc} heads a CTA), {name}: device {dev_ms:.4f} ms, "
                  f"events {ev_ms:.4f} ms on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
