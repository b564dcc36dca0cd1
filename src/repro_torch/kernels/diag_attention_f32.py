"""The float32 attention pair beside the kernels it replaced, on the card.

    python3 src/repro_torch/kernels/diag_attention_f32.py

Builds, with nvcc into ``build/diag/``, ``csrc/diag/flash_attention_f32_
pr31.cu`` (the forward, delta, dK/dV and dQ kernels on the CUDA cores, as
they stood before the tensor-core redesigns; only their names changed).
At smollm-360m's training shape (B 8, S 256, H 15 over 5, D 64) and
llama2-7b's (B 1, S 2,048, H 32, D 128), the library's forward, dK/dV and
dQ kernels and the CUDA-core ones are held against the plain forward in
float64 and its autograd within 1e-5 x max|ref| a tensor and timed in
turns (CUDA events, median, and torch.profiler's device time), beside
SDPA's float32 forward and backward (all three gradients).  Prints
``[diag_attention_f32]`` lines with nvidia-smi's name and power limit;
exits 1 if a kernel misses the tolerance.  ``chip_smoke.py``'s kernels
phase times the CUDA-core kernels the same way (``start_build`` / ``load``
/ ``cuda_core_fwd`` / ``cuda_core_dkdv`` / ``cuda_core_dq``).  Needs a card
and nvcc.
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
OLD_SRC = os.path.join(CSRC, "diag", "flash_attention_f32_pr31.cu")
OLD_LIB = os.path.join(OUT, "libdiagattentionf32cudacores.so")
# device kernels of each CUDA-core entry, as the profiler names them
OLD_FWD_KERNELS = ("cuda_core_f32_fwd_kernel",)
OLD_DKDV_KERNELS = ("cuda_core_f32_delta", "cuda_core_f32_dkdv")
OLD_DQ_KERNELS = ("cuda_core_f32_dq",)
SHAPES = (("smollm-360m", 8, 256, 15, 5, 64), ("llama2-7b", 1, 2048, 32, 32,
                                                128))
REL = 1e-5


def start_build() -> subprocess.Popen:
    """nvcc of the CUDA-core kernels into ``OLD_LIB``, started (not waited
    for), so that it can run beside the library's build."""
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    return subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", OLD_LIB,
         OLD_SRC, "-lcudart"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(proc: subprocess.Popen | None = None) -> ctypes.CDLL:
    """The CUDA-core kernels' library, once ``proc`` (a :func:`start_build`,
    started here if None) has finished."""
    from repro_torch.kernels import build

    proc = proc or start_build()
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {OLD_SRC}:\n{out}")
    dll = ctypes.CDLL(OLD_LIB)
    for name, lib_name in (("diag_attention_f32_fwd_cuda_cores",
                            "repro_attention_f32_fwd"),
                           ("diag_attention_f32_dkdv_cuda_cores",
                            "repro_attention_f32_dkdv"),
                           ("diag_attention_f32_dq_cuda_cores",
                            "repro_attention_f32_dq")):
        getattr(dll, name).argtypes = build.SIGNATURES[lib_name]
        getattr(dll, name).restype = ctypes.c_int
    return dll


def _check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"the CUDA-core {name} kernel failed to launch "
                           f"({status})")


def cuda_core_fwd(dll: ctypes.CDLL, q, k, v):
    """The CUDA-core forward with ``attention_f32_fwd``'s arguments: (o,
    lse)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import _qkv_strides

    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _check(dll.diag_attention_f32_fwd_cuda_cores(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s, h, k.shape[2], d, _qkv_strides(q, k, v),
        float(d ** -0.5), build.stream_handle(q.device)), "forward")
    return o, lse


def cuda_core_dkdv(dll: ctypes.CDLL, q, k, v, o, lse, do):
    """The CUDA-core delta + dK/dV kernels with ``attention_f32_dkdv``'s
    arguments: (dk, dv, delta)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import _qkv_strides

    b, s, h, d = q.shape
    hkv = k.shape[2]
    dk = torch.empty((b, s, hkv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _check(dll.diag_attention_f32_dkdv_cuda_cores(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, s, h, hkv, d, _qkv_strides(q, k, v),
        float(d ** -0.5), build.stream_handle(q.device)), "dK/dV")
    return dk, dv, delta


def cuda_core_dq(dll: ctypes.CDLL, q, k, v, lse, do, delta):
    """The CUDA-core dQ kernel with ``attention_f32_dq``'s arguments."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import _qkv_strides

    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    _check(dll.diag_attention_f32_dq_cuda_cores(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, h, k.shape[2],
        d, _qkv_strides(q, k, v), float(d ** -0.5),
        build.stream_handle(q.device)), "dQ")
    return dq


def _time(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
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


def _device_ms(torch, fn, names) -> float:
    """Device ms per call of the kernels named ``names`` (None: every
    device kernel) under torch.profiler (nan if it drops records)."""
    from repro_torch.kernels import profiling

    return profiling.device_ms(torch, lambda i: fn(), {"k": names})["k"]


def main() -> int:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_f32_fwd_ref

    proc = start_build()
    build.library()
    old = load(proc)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(32)
    bad = 0
    for tag, b, s, h, hkv, d in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       for shape in ((b, s, h, d), (b, s, hkv, d),
                                     (b, s, hkv, d), (b, s, h, d)))
        o, lse = ops.attention_f32_fwd(q, k, v)
        leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
        o64, lse64 = attention_f32_fwd_ref(*leaves)
        want = (o64.detach(), lse64.detach(),
                *torch.autograd.grad(o64, leaves, do.double()))
        del leaves, o64, lse64
        runs = {
            "library": (lambda: ops.attention_f32_fwd(q, k, v),
                        lambda: ops.attention_f32_dkdv(q, k, v, o, lse, do),
                        lambda dl: ops.attention_f32_dq(q, k, v, lse, do, dl),
                        (("attention_f32_fwd",), ("attention_f32_dkdv",),
                         ("attention_f32_dq",))),
            "CUDA cores": (lambda: cuda_core_fwd(old, q, k, v),
                           lambda: cuda_core_dkdv(old, q, k, v, o, lse, do),
                           lambda dl: cuda_core_dq(old, q, k, v, lse, do, dl),
                           (OLD_FWD_KERNELS, OLD_DKDV_KERNELS,
                            OLD_DQ_KERNELS))}
        for name, (fwd, dkdv, dq, _names) in runs.items():
            dk, dv, delta = dkdv()
            got = (*fwd(), dq(delta), dk, dv)
            errs = [((g.double() - w).abs().max() / w.abs().max()).item()
                    for g, w in zip(got, want)]
            bad += any(not e <= REL for e in errs)
            print(f"[diag_attention_f32] {tag} {name}: max|err|/max|ref| "
                  + ", ".join(f"{n} {e:.2e}" for n, e in zip(
                      ("O", "lse", "dq", "dk", "dv"), errs))
                  + f" (tol {REL})", flush=True)
        delta = runs["library"][1]()[2]
        parts = ("fwd", "dkdv", "dq")
        fns = {n: (r[0], r[1], lambda dq=r[2]: dq(delta))
               for n, r in runs.items()}
        ms = {(n, p): [] for n in runs for p in parts}
        for name in list(runs) + list(runs)[::-1]:
            for part, fn in zip(parts, fns[name]):
                ms[name, part].append(_time(torch, fn))
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=h != hkv)

        with torch.no_grad():
            sdpa_f = (_time(torch, sdpa_fwd), _device_ms(torch, sdpa_fwd,
                                                         None))
        out = sdpa_fwd()
        dot = do.transpose(1, 2).contiguous()

        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        sdpa = (_time(torch, sdpa_bwd), _device_ms(torch, sdpa_bwd, None))
        for name in runs:
            dev = [_device_ms(torch, fn, kn)
                   for fn, kn in zip(fns[name], runs[name][3])]
            t = {p: ms[name, p] for p in parts}
            print(f"[diag_attention_f32] {tag} B={b} S={s} H={h} Hkv={hkv} "
                  f"D={d} {name}: "
                  + "; ".join(f"{p} {statistics.mean(t[p]):.4f} ms (turns "
                              f"{t[p][0]:.4f} / {t[p][1]:.4f}), device "
                              f"{x:.4f} ms" for p, x in zip(parts, dev))
                  + f"; dK/dV + dQ device {dev[1] + dev[2]:.4f} ms; SDPA "
                  f"float32 forward {sdpa_f[0]:.4f} ms, device "
                  f"{sdpa_f[1]:.4f} ms; backward {sdpa[0]:.4f} ms, device "
                  f"{sdpa[1]:.4f} ms; {smi}", flush=True)
        del qt, kt, vt, out, dot
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
