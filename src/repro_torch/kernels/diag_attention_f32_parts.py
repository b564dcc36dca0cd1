"""What each design choice of the float32 attention pair buys: the
forward, dK/dV and dQ kernels built as they are and with one choice undone
at a time, on the card.

    python3 src/repro_torch/kernels/diag_attention_f32_parts.py [--only fwd|bwd]

Builds ``csrc/flash_attention_f32.cu`` as it is and a copy for each entry
of ``UNDONE`` (text replacements in the source, which for the forward's
split-once choices add their device functions; the script stops if a text
is not there), each with nvcc into ``build/diag/``, and calls each
copy's three entries at smollm-360m's training shape (B 8, S 256, H 15 over
5, D 64) and llama2-7b's (B 1, S 2,048, H 32, D 128): max|err| / max|ref|
of O and lse against the plain forward in float64 and of dq, dk and dv
against its autograd (the backward from the library's O and lse; the
kernels' gate is 1e-5), and device time per call from torch.profiler (the
forward, dK/dV with its delta pass, and dQ), each copy timed twice in turns
(forward order, then reversed).  ``--only fwd`` (``bwd``) builds only the
copies whose choice is the forward's (the backward's) or both's.  Prints
``[diag_attention_f32_parts]`` lines with nvidia-smi's name and power
limit.  Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import re
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
_FWD_STEP = "constexpr int kFwdStep = 32;"
_S_LOOP = ("#pragma unroll\n      for (int kk = 0; kk < D; kk += 8) {\n"
           "        SplitA aq;")
_PV = "          mma_3xtf32_add2(o_acc[u], a0, b0, a1, b1);"
# the forward's operands split once in shared memory (big in place, small
# in a tile of its own) rather than by each warp at every fragment load:
# the device functions, added before the kernel
_FWD_KERNEL = "// O = softmax(Q K^T scale, causal) V and lse"
_SPLIT_ONCE = """\
template <int D, int ROWS>
__device__ __forceinline__ void split_rows(float* t, float* small) {
  constexpr int kVec = D / 4, LD = bwd_ld<D>();
#pragma unroll
  for (int it = 0; it < ROWS * kVec / kBwdThreads; ++it) {
    const int idx = threadIdx.x + it * kBwdThreads;
    const int off = idx / kVec * LD + idx % kVec * 4;
    float4 x = *reinterpret_cast<const float4*>(t + off), lo;
    uint32_t bg, sm;
    split_tf32(x.x, bg, sm);
    x.x = __uint_as_float(bg);
    lo.x = __uint_as_float(sm);
    split_tf32(x.y, bg, sm);
    x.y = __uint_as_float(bg);
    lo.y = __uint_as_float(sm);
    split_tf32(x.z, bg, sm);
    x.z = __uint_as_float(bg);
    lo.z = __uint_as_float(sm);
    split_tf32(x.w, bg, sm);
    x.w = __uint_as_float(bg);
    lo.w = __uint_as_float(sm);
    *reinterpret_cast<float4*>(t + off) = x;
    *reinterpret_cast<float4*>(small + off) = lo;
  }
}

template <int LD>
__device__ __forceinline__ void load_a_pre(const float* t, const float* small, int r0, int c0,
                                           int g, int q, SplitA& s) {
  const int i = (r0 + g) * LD + c0 + q, j[4] = {i, i + 8 * LD, i + 4, i + 8 * LD + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s.big[e] = __float_as_uint(t[j[e]]);
    s.small[e] = __float_as_uint(small[j[e]]);
  }
}

// b0 at element i of the tile, b1 `step` floats on
__device__ __forceinline__ void load_b_pre(const float* t, const float* small, int i, int step,
                                           SplitB& s) {
  s.big[0] = __float_as_uint(t[i]);
  s.big[1] = __float_as_uint(t[i + step]);
  s.small[0] = __float_as_uint(small[i]);
  s.small[1] = __float_as_uint(small[i + step]);
}

"""
_FWD_SMEM = "  return (kRows + 4 * kFwdStep) * bwd_ld<D>() * 4;"
_SV = "  float* sV = sK + 2 * KS * LD;                        // [2][KS][LD]\n"
_TV = "    float* tV = sV + buf * KS * LD;\n"
# a choice whose shared memory leaves one CTA an SM at D 128 lifts the
# source's compile-time check of two
_ONE_CTA = ("fwd_ctas<128>() >= 2,", "fwd_ctas<128>() >= 1,")
# choice undone -> (the kernels it concerns: "fwd", "bwd" or "all",
# [(text of the source, its replacement)])
UNDONE = {
    "as it is": ("all", []),
    "one accumulator a walk (no rounded adds)": ("all", [(
        "  float t[4] = {0.f, 0.f, 0.f, 0.f};\n  mma_3xtf32(t, a0, b0);\n"
        "  mma_3xtf32(t, a1, b1);\n#pragma unroll\n"
        "  for (int e = 0; e < 4; ++e) c[e] += t[e];",
        "  mma_3xtf32(c, a0, b0);\n  mma_3xtf32(c, a1, b1);")]),
    "one score accumulator (no hi / lo)": ("all", [(
        "  mma_tf32(lo, a.small, b.big[0], b.big[1]);\n"
        "  mma_tf32(lo, a.big, b.small[0], b.small[1]);",
        "  mma_tf32(hi, a.small, b.big[0], b.big[1]);\n"
        "  mma_tf32(hi, a.big, b.small[0], b.small[1]);")]),
    "split by cvt.rna.tf32": ("all", [(
        "  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
        "  small = __float_as_uint(x - __uint_as_float(big));", _CVT)]),
    "one CTA a group (no cluster)": ("bwd", [(
        "for (int c = kMaxCtas; c > 1; --c) {",
        "for (int c = 1; c > 1; --c) {")]),
    "backward steps of 64 / 32 (D 64 / 128)": ("bwd", [(
        "bwd_step() {\n  return D == 64 ? 32 : 16;",
        "bwd_step() {\n  return D == 64 ? 64 : 32;")]),
    "forward: one accumulator for O's walk": ("fwd", [(
        _PV, "          mma_3xtf32(o_acc[u], a0, b0);\n"
             "          mma_3xtf32(o_acc[u], a1, b1);")]),
    "forward: Q split once in shared memory": ("fwd", [
        (_FWD_KERNEL, _SPLIT_ONCE + _FWD_KERNEL),
        (_FWD_SMEM, _FWD_SMEM.replace("(kRows", "(2 * kRows")), _ONE_CTA,
        (_SV, _SV + "  float* sQs = sV + 2 * KS * LD;\n"),
        (_TV, _TV + "    if (n == 0) {\n      split_rows<D, kRows>(sQ, sQs);\n"
                    "      __syncthreads();\n    }\n"),
        ("\n        load_a<LD>(sQ, i0, kk, g, qd, aq);",
         "\n        load_a_pre<LD>(sQ, sQs, i0, kk, g, qd, aq);")]),
    "forward: K, V split once a step in shared memory": ("fwd", [
        (_FWD_KERNEL, _SPLIT_ONCE + _FWD_KERNEL),
        (_FWD_SMEM, _FWD_SMEM.replace("4 * kFwdStep", "6 * kFwdStep")),
        _ONE_CTA,
        (_SV, _SV + "  float* sKs = sV + 2 * KS * LD;\n"
                    "  float* sVs = sKs + KS * LD;\n"),
        (_TV, _TV + "    split_rows<D, KS>(tK, sKs);\n"
                    "    split_rows<D, KS>(tV, sVs);\n    __syncthreads();\n"),
        ("\n          load_b_t<LD>(tK, 8 * t, kk, g, qd, bk);",
         "\n          load_b_pre(tK, sKs, (8 * t + g) * LD + kk + qd, 4, bk);"),
        ("load_b_rows<LD>(tV, 8 * t, 8 * u, g, qd, b0);",
         "load_b_pre(tV, sVs, (8 * t + 2 * qd) * LD + 8 * u + g, LD, b0);"),
        ("load_b_rows<LD>(tV, 8 * t + 8, 8 * u, g, qd, b1);",
         "load_b_pre(tV, sVs, (8 * t + 8 + 2 * qd) * LD + 8 * u + g, LD, "
         "b1);")]),
    "forward: steps of 16 keys": ("fwd", [(
        _FWD_STEP, "constexpr int kFwdStep = 16;")]),
    "forward: steps of 64 keys": ("fwd", [(
        _FWD_STEP, "constexpr int kFwdStep = 64;"), _ONE_CTA]),
    "forward: the score loop unrolled by 2": ("fwd", [(
        _S_LOOP, _S_LOOP.replace("unroll", "unroll 2"))]),
    "forward: at most 2 CTAs an SM (D 64)": ("fwd", [(
        "constexpr int kFwdMaxCtas = 3;", "constexpr int kFwdMaxCtas = 2;")]),
    "forward: at most 4 CTAs an SM (D 64)": ("fwd", [(
        "constexpr int kFwdMaxCtas = 3;", "constexpr int kFwdMaxCtas = 4;")]),
    "one-term TF32 (misses the gate)": ("all", [
        ("  mma_tf32(c, a.small, b.big[0], b.big[1]);\n"
         "  mma_tf32(c, a.big, b.small[0], b.small[1]);\n", ""),
        ("  mma_tf32(lo, a.small, b.big[0], b.big[1]);\n"
         "  mma_tf32(lo, a.big, b.small[0], b.small[1]);\n", "")]),
}
SHAPES = (("smollm-360m", 8, 256, 15, 5, 64),
          ("llama2-7b", 1, 2048, 32, 32, 128))
ENTRIES = ("repro_attention_f32_fwd", "repro_attention_f32_dkdv",
           "repro_attention_f32_dq")
PARTS = ("fwd", "dkdv", "dq")


def _build(only: str | None) -> dict:
    """nvcc of every copy (those ``only`` concerns), in parallel: name ->
    loaded library."""
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    text = open(SRC).read()
    procs = {}
    for i, (name, (kind, reps)) in enumerate(UNDONE.items()):
        if only and kind not in (only, "all"):
            continue
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
        print(f"[diag_attention_f32_parts] {name}: ptxas "
              + "; ".join(_ptxas(out)), flush=True)
        dll = ctypes.CDLL(lib)
        for entry in ENTRIES:
            getattr(dll, entry).argtypes = build.SIGNATURES[entry]
            getattr(dll, entry).restype = ctypes.c_int
        libs[name] = dll
    return libs


def _ptxas(log: str) -> list[str]:
    """Registers and spills of each kernel in an nvcc -Xptxas -v log."""
    from repro_torch.kernels import profiling

    out = []
    for name, used, spill in profiling.ptxas_entries(log):
        short = re.search(r"attention_f32_(\w+?)_kernelILi(\d+)", name)
        out.append(f"{short.group(1)}<{short.group(2)}> {used} ({spill})"
                   if short else f"{name}: {used} ({spill})")
    return out


def _run(dll, q, k, v, o, lse, do):
    """(O, lse) of one copy's forward and (dq, dk, dv) of its backward
    from the given o and lse."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import _qkv_strides

    b, s, h, d = q.shape
    hkv = k.shape[2]
    o2 = torch.empty_like(q)
    lse2 = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, s, hkv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    st, stream = _qkv_strides(q, k, v), build.stream_handle(q.device)
    for status in (
            dll.repro_attention_f32_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(),
                lse2.data_ptr(), b, s, h, hkv, d, st, float(d ** -0.5),
                stream),
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
    return o2, lse2, dq, dk, dv


def _device_ms(torch, fn) -> dict:
    """Device ms per call of the forward, of the dK/dV entry's kernels and
    of dQ's under torch.profiler (nan for a part whose records it drops)."""
    from repro_torch.kernels import profiling

    return profiling.device_ms(
        torch, lambda i: fn(), {p: (f"attention_f32_{p}_",) for p in PARTS})


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("fwd", "bwd"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_f32_fwd_ref

    libs = _build(args.only)
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
        o64, lse64 = attention_f32_fwd_ref(*leaves)
        want = (o64.detach(), lse64.detach(),
                *torch.autograd.grad(o64, leaves, do.double()))
        del leaves, o64, lse64
        times = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                times[name].append(_device_ms(torch, lambda: _run(
                    libs[name], q, k, v, o, lse, do)))
        for name, dll in libs.items():
            got = _run(dll, q, k, v, o, lse, do)
            errs = [((g.double() - w).abs().max() / w.abs().max()).item()
                    for g, w in zip(got, want)]
            t = times[name]
            print(f"[diag_attention_f32_parts] {tag} B={b} S={s} H={h} "
                  f"Hkv={hkv} D={d} {name}: max|err|/max|ref| "
                  + ", ".join(f"{n} {e:.2e}" for n, e in zip(
                      ("O", "lse", "dq", "dk", "dv"), errs))
                  + "; device ms (two turns) "
                  + ", ".join(f"{p} {t[0][p]:.4f} / {t[1][p]:.4f}"
                              for p in PARTS)
                  + f", dK/dV + dQ {sum(x['dkdv'] + x['dq'] for x in t) / 2:.4f}"
                  f"; {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
