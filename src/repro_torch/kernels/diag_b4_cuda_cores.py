"""B4 before and after its tensor-core redesign, timed in one run on the card.

    python3 src/repro_torch/kernels/diag_b4_cuda_cores.py

Builds ``csrc/diag/w4a16_gemv_cuda_cores.cu`` (the W4A16 kernels as they
were, float32 x, products on the CUDA cores) with nvcc into ``build/diag/``
and times it beside the library's kernels at the shapes the W4A16 paths run:
the GeMV at M 4 (llama2-7b's lm_head, zamba2-7b's shared block q/k/v/o,
gate/up and down, and its lm_head) and the tiled variant at M 2048
(zamba2-7b's prefill group: gate/up, down, q/k/v/o).  In turns, old, new,
new, old: the old kernel on float32 x, the new one on bf16 x (the path's
dtype) and on float32 x.  Each output is first held against the plain
version within chip_smoke.py's W4_TOL.  Device time per call from
torch.profiler, with nvidia-smi's name and power limit.  Needs a card and
nvcc; prints ``[diag_b4]`` lines.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "diag",
                   "w4a16_gemv_cuda_cores.cu")
SHAPES = [(4, 4096, 32000, "llama2-7b lm_head"),
          (4, 3584, 3584, "zamba2-7b q/k/v/o"),
          (4, 3584, 14336, "zamba2-7b gate/up"),
          (4, 14336, 3584, "zamba2-7b down"),
          (4, 3584, 32000, "zamba2-7b lm_head"),
          (2048, 3584, 14336, "zamba2-7b gate/up"),
          (2048, 14336, 3584, "zamba2-7b down"),
          (2048, 3584, 3584, "zamba2-7b q/k/v/o")]
W4_REL, W4_ABS = 1e-5, 1e-6


def _build() -> ctypes.CDLL:
    from repro_torch.kernels import build

    out = os.path.join(ROOT, "build", "diag")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libdiagb4.so")
    res = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", lib, SRC,
         "-lcudart"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}")
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.diag_w4a16_gemv_cuda_cores.argtypes = [p] * 4 + [i] * 6 + [p]
    dll.diag_w4a16_gemm_cuda_cores.argtypes = [p] * 4 + [i] * 5 + [p]
    dll.diag_w4a16_gemv_cuda_cores.restype = i
    dll.diag_w4a16_gemm_cuda_cores.restype = i
    return dll


def _device_ms(torch, fn, n_bufs: int, iters: int = 10,
               tries: int = 3) -> float:
    """Device time per call (ms) under torch.profiler; a window whose
    kernel records are not a whole number per call (some were dropped) is
    taken again, up to ``tries`` windows, then nan."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i % n_bufs)
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
        print("diag_b4_cuda_cores: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.w4a16_gemv.ops import w4a16_gemm
    from repro_torch.kernels.w4a16_gemv.ref import w4a16_gemm_ref
    from repro_torch.quant.int4 import dequantize4, quantize_weight4

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    dll = _build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    stream = build.stream_handle(dev)
    for m, k, n, tag in SHAPES:
        g = min(128, k)
        ng = -(-k // g)
        # weight copies that a decode GeMV streams from device memory
        copies = max(4, -(-120_000_000 // (n * k // 2))) if m <= 8 else 1
        q = quantize_weight4(torch.randn((n, k), generator=gen, device=dev)
                             * k ** -0.5)
        wps = [q.w_packed.contiguous()] + [
            torch.randint(0, 256, (n, k // 2), generator=gen, device=dev,
                          dtype=torch.uint8) for _ in range(copies - 1)]
        x = torch.randn((m, k), generator=gen, device=dev)
        xb = x.to(torch.bfloat16)
        out = torch.empty((m, n), dtype=torch.float32, device=dev)

        def old(i):
            if m <= 8:
                st = dll.diag_w4a16_gemv_cuda_cores(
                    x.data_ptr(), wps[i].data_ptr(), q.scale.data_ptr(),
                    out.data_ptr(), m, n, k, g, ng, int(k % 8 == 0), stream)
            else:
                st = dll.diag_w4a16_gemm_cuda_cores(
                    x.data_ptr(), wps[i].data_ptr(), q.scale.data_ptr(),
                    out.data_ptr(), m, n, k, g, ng, stream)
            if st != 0:
                raise RuntimeError(f"diag kernel failed to launch ({st})")

        old(0)
        limit = W4_REL * (x.abs() @ dequantize4(q).abs().T) + W4_ABS
        for what, got in (("old, f32 x", out),
                          ("new, bf16 x", w4a16_gemm(xb, wps[0], q.scale)),
                          ("new, f32 x", w4a16_gemm(x, wps[0], q.scale))):
            ref = w4a16_gemm_ref(xb if "bf16" in what else x, wps[0],
                                 q.scale)
            used = ((got - ref).abs() / limit).max().item()
            if used > 1.0:
                raise AssertionError(f"{what} M={m} K={k} N={n}: worst "
                                     f"|err|/W4_TOL {used:.3f}")
        runs = {"old f32 x": old,
                "new bf16 x": lambda i: w4a16_gemm(xb, wps[i], q.scale),
                "new f32 x": lambda i: w4a16_gemm(x, wps[i], q.scale)}
        times = {name: [] for name in runs}
        for name in ("old f32 x", "new bf16 x", "new f32 x", "new f32 x",
                     "new bf16 x", "old f32 x"):
            times[name].append(_device_ms(torch, runs[name], copies,
                                          iters=5 if name.startswith("old")
                                          and m > 8 else 10))
        ops = 2 * m * n * k
        parts = "; ".join(
            f"{name} {min(t):.4f} ms ({' / '.join(f'{v:.4f}' for v in t)}, "
            f"{ops / min(t) / 1e9:.1f} TFLOP/s)"
            for name, t in times.items())
        print(f"[diag_b4] M={m} K={k} N={n} ({tag}): device per call, best of "
              f"two turns: {parts}; old / new (bf16) "
              f"{min(times['old f32 x']) / min(times['new bf16 x']):.1f}x on "
              f"{smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
