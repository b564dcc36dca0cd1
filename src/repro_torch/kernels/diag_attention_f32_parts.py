"""What each design choice of the float32 attention backward buys: the
dK/dV and dQ kernels built as they are and with one choice undone at a
time, on the card.

    python3 src/repro_torch/kernels/diag_attention_f32_parts.py

Builds ``csrc/flash_attention_f32.cu`` as it is and a copy for each entry
of ``UNDONE`` (a text replacement in the source; the script stops if the
text is not there), each with nvcc into ``build/diag/``, and calls each
copy's dK/dV and dQ entries at smollm-360m's training shape (B 8, S 256, H
15 over 5, D 64) and llama2-7b's (B 1, S 2,048, H 32, D 128): max|err| /
max|ref| of dq, dk and dv against autograd of the plain forward in float64
(the kernels' gate is 1e-5), and device time per call from torch.profiler
(dK/dV with its delta pass, and dQ), each copy timed twice in turns
(forward order, then reversed).  Prints ``[diag_attention_f32_parts]``
lines with nvidia-smi's name and power limit.  Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
SRC = os.path.join(CSRC, "flash_attention_f32.cu")
OUT = os.path.join(ROOT, "build", "diag")
_CVT = ('  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));\n'
        '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) : "f"(x - '
        '__uint_as_float(big)));')
# choice undone -> [(text of the source, its replacement)]
UNDONE = {
    "as it is": [],
    "one accumulator a walk (no rounded adds)": [(
        "  float t[4] = {0.f, 0.f, 0.f, 0.f};\n  mma_3xtf32(t, a0, b0);\n"
        "  mma_3xtf32(t, a1, b1);\n#pragma unroll\n"
        "  for (int e = 0; e < 4; ++e) c[e] += t[e];",
        "  mma_3xtf32(c, a0, b0);\n  mma_3xtf32(c, a1, b1);")],
    "one score accumulator (no hi / lo)": [(
        "  mma_tf32(lo, a.small, b.big[0], b.big[1]);\n"
        "  mma_tf32(lo, a.big, b.small[0], b.small[1]);",
        "  mma_tf32(hi, a.small, b.big[0], b.big[1]);\n"
        "  mma_tf32(hi, a.big, b.small[0], b.small[1]);")],
    "split by cvt.rna.tf32": [(
        "  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
        "  small = __float_as_uint(x - __uint_as_float(big));", _CVT)],
    "one CTA a group (no cluster)": [(
        "for (int c = kMaxCtas; c > 1; --c) {",
        "for (int c = 1; c > 1; --c) {")],
    "steps of 64 / 32 (D 64 / 128)": [(
        "return D == 64 ? 32 : 16;", "return D == 64 ? 64 : 32;")],
    "one-term TF32 (misses the gate)": [
        ("  mma_tf32(c, a.small, b.big[0], b.big[1]);\n"
         "  mma_tf32(c, a.big, b.small[0], b.small[1]);\n", ""),
        ("  mma_tf32(lo, a.small, b.big[0], b.big[1]);\n"
         "  mma_tf32(lo, a.big, b.small[0], b.small[1]);\n", "")],
}
SHAPES = (("smollm-360m", 8, 256, 15, 5, 64),
          ("llama2-7b", 1, 2048, 32, 32, 128))
ENTRIES = ("repro_attention_f32_dkdv", "repro_attention_f32_dq")


def _build() -> dict:
    """nvcc of every copy, in parallel: name -> loaded library."""
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    text = open(SRC).read()
    procs = {}
    for i, (name, reps) in enumerate(UNDONE.items()):
        src = text
        for old, new in reps:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in {SRC}")
            src = src.replace(old, new)
        cu = os.path.join(OUT, f"attention_f32_part{i}.cu")
        lib = os.path.join(OUT, f"libattentionf32part{i}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", CSRC, "-shared",
             "-o", lib, cu, "-lcudart"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        dll = ctypes.CDLL(lib)
        for entry in ENTRIES:
            getattr(dll, entry).argtypes = build.SIGNATURES[entry]
            getattr(dll, entry).restype = ctypes.c_int
        libs[name] = dll
    return libs


def _backward(dll, q, k, v, o, lse, do):
    """(dq, dk, dv) from one copy's two entries."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import _qkv_strides

    b, s, h, d = q.shape
    hkv = k.shape[2]
    dk = torch.empty((b, s, hkv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    st, stream = _qkv_strides(q, k, v), build.stream_handle(q.device)
    for status in (
            dll.repro_attention_f32_dkdv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, s, h, hkv, d, st,
                float(d ** -0.5), stream),
            dll.repro_attention_f32_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                do.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, h, hkv,
                d, st, float(d ** -0.5), stream)):
        if status != 0:
            raise RuntimeError(f"a copy failed to launch ({status})")
    return dq, dk, dv


def _device_ms(torch, fn, iters: int = 10) -> dict:
    """Device ms per call of the dK/dV entry's kernels and of dQ's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {"dkdv": 0.0, "dq": 0.0}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            part = ("dkdv" if "attention_f32_dkdv_" in ev.key else
                    "dq" if "attention_f32_dq_" in ev.key else None)
            if part:
                out[part] += getattr(ev, "self_device_time_total", 0.0) \
                    / 1e3 / iters
    return out


def main() -> int:
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_f32_fwd_ref

    libs = _build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(32)
    for tag, b, s, h, hkv, d in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       for shape in ((b, s, h, d), (b, s, hkv, d),
                                     (b, s, hkv, d), (b, s, h, d)))
        o, lse = ops.attention_f32_fwd(q, k, v)
        leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
        o64, _ = attention_f32_fwd_ref(*leaves)
        want = torch.autograd.grad(o64, leaves, do.double())
        del leaves, o64
        times = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                times[name].append(_device_ms(torch, lambda: _backward(
                    libs[name], q, k, v, o, lse, do)))
        for name, dll in libs.items():
            got = _backward(dll, q, k, v, o, lse, do)
            errs = [((g.double() - w).abs().max() / w.abs().max()).item()
                    for g, w in zip(got, want)]
            t = times[name]
            total = sum(x["dkdv"] + x["dq"] for x in t) / len(t)
            print(f"[diag_attention_f32_parts] {tag} B={b} S={s} H={h} "
                  f"Hkv={hkv} D={d} {name}: max|err|/max|ref| dq "
                  f"{errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e}; device "
                  f"ms dK/dV {t[0]['dkdv']:.4f} / {t[1]['dkdv']:.4f}, dQ "
                  f"{t[0]['dq']:.4f} / {t[1]['dq']:.4f}, sum "
                  f"{total:.4f} (two turns); {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
