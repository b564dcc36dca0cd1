"""The paged MLA decode kernel beside the kernel it replaced, on the card.

    python3 src/repro_torch/kernels/diag_mla.py

Builds, with nvcc into ``build/diag/``, ``csrc/diag/mla_decode_attention_
pr27.cu`` (the CUDA-core split-KV kernel and its combine kernel, as they
stood before the tensor-core redesign; only their names changed).  At
deepseek-v2-lite-16b's shapes (B 4, H 16, R 512, Dr 64, pages of 16, 1,024
keys a slot; lengths 1024 / 545 / 17 / 0 and the serve trace's 403 / 331 /
275 / 439), over bf16 and int8 pools, the PR 27 kernel and the library's
are held against the plain version within 1e-5 x max|ckv| and timed in
turns (CUDA events, median, and torch.profiler's device time).  Prints
``[diag_mla]`` lines with nvidia-smi's name and power limit; exits 1 if a
kernel misses the tolerance.  ``chip_smoke.py``'s kernels phase times the
PR 27 kernel the same way (``start_build`` / ``load`` / ``pr27``).  Needs
a card and nvcc.
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
OUT = os.path.join(ROOT, "build", "diag")
PR27_SRC = os.path.join(CSRC, "diag", "mla_decode_attention_pr27.cu")
PR27_LIB = os.path.join(OUT, "libdiagmlapr27.so")
PR27_ENTRY = "diag_mla_decode_attention_pr27"
PR27_KERNELS = ("pr27_mla_",)
CASES = (("1024/545/17/0", [1024, 545, 17, 0]),
         ("serve trace", [403, 331, 275, 439]))


def start_build() -> subprocess.Popen:
    """nvcc of the PR 27 kernel into ``PR27_LIB``, started (not waited
    for), so that it can run beside the library's build."""
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    return subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", CSRC, "-shared", "-o",
         PR27_LIB, PR27_SRC, "-lcudart"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(proc: subprocess.Popen, what: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what}:\n{out}")
    return out


def load(proc: subprocess.Popen | None = None) -> ctypes.CDLL:
    """The PR 27 kernel's library, once ``proc`` (a :func:`start_build`,
    started here if None) has finished."""
    _wait(proc or start_build(), PR27_SRC)
    dll = ctypes.CDLL(PR27_LIB)
    p, i = ctypes.c_void_p, ctypes.c_int
    getattr(dll, PR27_ENTRY).argtypes = [p] * 10 + [i] * 8 + [
        ctypes.c_float, p]
    getattr(dll, PR27_ENTRY).restype = i
    return dll


def _pools(ckv_pages, krope_pages):
    (ckv, cs), (kr, ks) = ((pool if isinstance(pool, tuple) else (pool, None))
                           for pool in (ckv_pages, krope_pages))
    return ckv, kr, cs, ks


def pr27(dll: ctypes.CDLL, q_c, q_rope, ckv_pages, krope_pages, block,
         lengths, scale: float):
    """The PR 27 kernel (split + combine) with ``mla_decode_attention``'s
    arguments (CUDA tensors the wrapper would take)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.mla_decode_attention.ref import SPLIT

    ckv, kr, cs, ks = _pools(ckv_pages, krope_pages)
    b, h, r = q_c.shape
    dr = q_rope.shape[-1]
    page, pps = ckv.shape[1], block.shape[1]
    n_split = -(-pps * page // SPLIT)
    ws = torch.empty(b * n_split * h * (r + 2), dtype=torch.float32,
                     device=q_c.device)
    out = torch.empty((b, h, r), dtype=torch.float32, device=q_c.device)
    status = getattr(dll, PR27_ENTRY)(
        q_c.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
        cs.data_ptr() if cs is not None else None,
        ks.data_ptr() if ks is not None else None, block.data_ptr(),
        lengths.data_ptr(), ws.data_ptr(), out.data_ptr(), b, h, r, dr, page,
        pps, n_split, int(cs is not None), float(scale),
        build.stream_handle(q_c.device))
    if status != 0:
        raise RuntimeError(f"the PR 27 MLA kernel failed to launch ({status})")
    return out


def _time(torch, fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(torch, fn, names, iters: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA") \
                and any(n in ev.key for n in names):
            total += getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
    return total / 1e3 / iters if total > 0 else float("nan")


def main() -> int:
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.mla_decode_attention.ops import (
        mla_decode_attention)
    from repro_torch.kernels.mla_decode_attention.ref import (
        mla_decode_attention_ref)
    from repro_torch.models.attention import gather_paged_rows, quantize_rows

    proc = start_build()
    build.library()
    old = load(proc)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    scale, h, r, dr, page, pps = 192 ** -0.5, 16, 512, 64, 16, 64
    bad = 0
    for kv in ("bf16", "int8"):
        for tag, lens in CASES:
            b = len(lens)
            n = b * pps + 1
            ckv = torch.randn((n, page, r), generator=gen, device=dev)
            kr = torch.randn((n, page, dr), generator=gen, device=dev)
            pools = ((quantize_rows(ckv), quantize_rows(kr)) if kv == "int8"
                     else (ckv.to(torch.bfloat16), kr.to(torch.bfloat16)))
            block = (torch.randperm(n - 1, device=dev)[:b * pps] + 1) \
                .reshape(b, pps).to(torch.int32)
            q_c = torch.randn((b, h, r), generator=gen, device=dev) \
                * (0.6 / r ** .5)
            q_r = torch.randn((b, h, dr), generator=gen, device=dev) \
                * (0.6 / dr ** .5)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            args = (q_c, q_r, *pools, block, lengths, scale)
            ref = mla_decode_attention_ref(*args)
            tol = 1e-5 * gather_paged_rows(pools[0], block).float().abs() \
                .max().item()
            runs = {"PR 27 split + combine": (
                        lambda: pr27(old, *args), PR27_KERNELS),
                    "library": (lambda: mla_decode_attention(*args),
                                ("mla_decode_attention_kernel",))}
            ms = {k: [] for k in runs}
            for k in list(runs) + list(runs)[::-1]:
                ms[k].append(_time(torch, runs[k][0]))
            for k, (fn, names) in runs.items():
                err = (fn() - ref).abs()[lengths > 0].max().item()
                bad += not err <= tol
                print(f"[diag_mla] {kv} {tag} B=4 H=16 R=512 Dr=64: {k} "
                      f"{statistics.mean(ms[k]):.4f} ms (events, two turns "
                      f"{ms[k][0]:.4f} / {ms[k][1]:.4f}), device "
                      f"{_device_ms(torch, fn, names):.4f} ms, max|err| "
                      f"{err:.3e} (tol {tol:.3e}) on {smi}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
