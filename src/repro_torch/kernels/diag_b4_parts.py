"""Where the time of B4's prefill GEMM (``w4a16_gemm_wgmma_kernel``) goes:
the kernel timed whole and with parts taken out, on the card.

    python3 src/repro_torch/kernels/diag_b4_parts.py

Builds ``csrc/w4a16_gemv.cu`` as it is and five copies, each with parts
replaced by nothing (the outputs are then wrong, and only timed): the
producer's copies of x, its copies of the packed weights, its
dequantization, all three (what is left: the consumers' wgmma and folds
behind the producer's barrier handshakes), and the consumers' wgmma (what
is left: the producer's work).  Each goes into ``build/diag/`` with nvcc
and is timed through its C entry on bf16 x at zamba2-7b's prefill shapes
(M 2048: gate/up K 3584 -> N 14336, down 14336 -> 3584, q/k/v/o 3584 ->
3584): device time per call from torch.profiler, in turns (each cut, then
again in reverse order), with nvidia-smi's name and power limit.  Needs a
card and nvcc; prints ``[diag_b4_parts]`` lines.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
SRC = os.path.join(CSRC, "w4a16_gemv.cu")
NO_X = ("          cp_async16(slot + swz(r, c) * 2,\n                     x + ",
        "          if (M < 0) cp_async16(slot + swz(r, c) * 2,\n"
        "                     x + ")
NO_W = ("          cp_async16(slot + kWsX + kWsW + p * 32 + h * 16,",
        "          if (M < 0) cp_async16(slot + kWsX + kWsW + p * 32 + h * 16,")
NO_DEQ = ("            dequant8(wv[j], d);\n"
          "            st_shared16(wbf + swz(p, 4 * h + j)",
          "            d[0] = d[1] = d[2] = d[3] = wv[j];\n"
          "            if (M < 0) st_shared16(wbf + swz(p, 4 * h + j)")
NO_WGMMA = ("      hopper::wgmma_m64n128k16_bf16_ss(acc, hopper::desc_sw128(",
            "      if (M < 0) hopper::wgmma_m64n128k16_bf16_ss(acc, "
            "hopper::desc_sw128(")
# part taken out -> replacements in csrc/w4a16_gemv.cu
CUTS = {"whole kernel": [],
        "without the x copies": [NO_X],
        "without the weight copies": [NO_W],
        "without the dequantization": [NO_DEQ],
        "consumers only (no copies, no dequantization)": [NO_X, NO_W,
                                                          NO_DEQ],
        "producer only (no wgmma)": [NO_WGMMA]}
SHAPES = ((2048, 3584, 14336, "zamba2-7b gate/up"),
          (2048, 14336, 3584, "zamba2-7b down"),
          (2048, 3584, 3584, "zamba2-7b q/k/v/o"))


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
        cu, lib = (os.path.join(out, f"w4a16_parts_{i}{ext}")
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
        fn = ctypes.CDLL(lib).repro_w4a16_gemm
        fn.argtypes = build.SIGNATURES["repro_w4a16_gemm"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _device_ms(torch, fn, iters: int = 10, tries: int = 3) -> float:
    """Device time per call (ms) under torch.profiler; a window whose
    kernel records are not a whole number per call (some were dropped) is
    taken again, up to ``tries`` windows, then nan."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")]
        launches = sum(e.count for e in events)
        if launches and launches % iters == 0:
            return sum(getattr(e, "self_device_time_total", 0.0)
                       for e in events) / 1e3 / iters
    return float("nan")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("diag_b4_parts: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.quant.int4 import quantize_weight4

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    libs = _build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = build.stream_handle(dev)
    for m, k, n, tag in SHAPES:
        g = min(128, k)
        q = quantize_weight4(torch.randn((n, k), generator=gen, device=dev)
                             * k ** -0.5)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            fn = libs[name]

            def run():
                st = fn(x.data_ptr(), q.w_packed.data_ptr(),
                        q.scale.data_ptr(), out.data_ptr(), m, n, k, g,
                        -(-k // g), 0, 1, stream)
                if st != 0:
                    raise RuntimeError(f"{name}: launch failed ({st})")

            times[name].append(_device_ms(torch, run))
        ops = 2 * m * n * k
        parts = "; ".join(
            f"{name} {min(t):.4f} ms ({' / '.join(f'{v:.4f}' for v in t)}, "
            f"{ops / min(t) / 1e9:.0f} TFLOP/s)" for name, t in times.items())
        print(f"[diag_b4_parts] M={m} K={k} N={n} ({tag}), device per call, "
              f"best of two turns: {parts} on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
