#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases card,build,kernels

Phases, each printing its own lines:

1. card     nvidia-smi's name and power limit, torch's device name.
2. build    nvcc builds the port's kernels (src/repro_torch/kernels/csrc)
            for sm_90a, one process per source; prints ptxas's register /
            shared-memory / spill summary per kernel.
3. kernels  each kernel against its plain PyTorch version on the card, at
            the llama2-7b shapes of the serving path, the smollm-360m GQA
            shapes and zamba2-7b's shared block (head dim 112): the int8
            product bit-exact, the attention kernels within two bf16 steps
            of the reference; two planted faults (decode attention given a
            long lane one token or one page short) must fail that check,
            at D 128 and D 112.  B6 (ssd_intra_chunk) at the zamba2-7b and
            mamba2-130m prefill shapes, Q 8 and G 2, against its plain
            version in float64 within rtol = atol = 1e-4; two planted mask
            faults (j <= i+1 admitted, the diagonal dropped) must fail.
            Times each (CUDA events, median), its plain version and one
            PyTorch library call where one exists, beside the least time
            the card could take (bytes at 3.35 TB/s or operations at the
            H100's peak, whichever is larger), and the device time
            torch.profiler records, without the host's launch overhead.
4. model    llama2-7b.reduced() and zamba2-7b.reduced(), W8A8: the same
            weights on the card (kernels, bf16), on the CPU (plain
            versions, bf16) and on the CPU in float32; at prefill and at
            each of four decode steps the card's logits stay within 1.25x
            the CPU bf16 run's own distance from float32.  Then
            mamba2-130m at full width, W8A8: forward on 2 x 256 tokens
            under the same gate.
5. serve    llama2-7b at full width, W8A8, through the port's serving
            driver (launch/serve.py build_client -> ServingClient ->
            Router -> EngineCore): 8 greedy requests with 64-512-token
            prompts, 32 new tokens each.  Every kernel's launch counter is
            zeroed before and read after; B1-B3 must be > 0.
6. profile  torch.profiler over 6 decode steps of the same engine: device
            kernel time per step against the host's wall clock, and the
            kernels that take it.
7. hybrid   the paper's hybrid NPU+flash GeMV at llama2-7b's full width:
            its 224 layer matrices and lm_head, each made on the card from
            a seed, planned on Cambricon-LLM-S, quantized, ECC-encoded and
            corrupted at BER 2e-4; one token (b=1) through every matrix
            with hybrid_gemv (counters zeroed before, read after: B5 and
            B2 > 0).  Gates: B5's pages equal the plain decode's, and the
            int32 accumulators and outputs equal the plain path's on the
            same corrupted pages.  Prints the relative errors (clean, with
            ECC, without) by shape and B5 / B2 device time per sweep.
            Then ecc_resilience at full width, W8A8, BER 2e-4: every int8
            leaf corrupted (and decoded by B5), forward on 4 x 24 tokens;
            the top-1 agreement with ECC must not be below the raw one.
8. serve_w4a16  llama2-7b at full width through build_client(quant=
            "w4a16") (W8A8 layers, W4A16 lm_head, as the JAX convert
            makes them): 4 greedy requests; all complete, the first token
            equals a direct prefill's, and B4's launch counter is > 0.
9. serve_hybrid  zamba2-7b at full width (81 Mamba-2 layers, the shared
            attention block after every 6), W8A8, through build_client:
            4 slots, max_seq 1024, page 16, 8 greedy requests with
            64-512-token prompts, 32 new tokens each.  All complete, the
            first token equals a direct prefill's, and B6, B1, B2 and B3
            launched; then torch.profiler over 6 decode steps, as the
            profile phase does for llama2-7b.

The kernels phase also holds B4 (w4a16_gemv) and B5 (ecc_decode) against
their plain versions, with two planted faults that must fail (B5 with the
last sidecar entry's restore skipped, B4 with lo/hi nibbles swapped).

The last three lines are the kernels JSON, nvidia-smi's line and
``{"ok": true, "device": {...}}``; each kernel's ``launches`` is read
around the run of the phase that owns it (serve for B1-B3, hybrid for
B5, serve_w4a16 for B4, serve_hybrid for B6).  Any failure raises and
the script exits non-zero; without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero before
printing a result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
# dense tensor-core peaks, and float32 outside the tensor cores
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

# kernel -> (source in the repository, Pallas kernel it replaces)
SOURCES = {
    "int8_gemv": ("src/repro_torch/kernels/csrc/int8_gemm.cu",
                  "src/repro/kernels/int8_pagegemv/int8_pagegemv.py:40"),
    "int8_gemm": ("src/repro_torch/kernels/csrc/int8_gemm.cu",
                  "src/repro/kernels/int8_pagegemv/int8_pagegemv.py:40"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:61"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:59"),
    "w4a16_gemv": ("src/repro_torch/kernels/csrc/w4a16_gemv.cu",
                   "src/repro/kernels/w4a16_gemv/w4a16_gemv.py:43"),
    "ecc_decode": ("src/repro_torch/kernels/csrc/ecc_decode.cu",
                   "src/repro/kernels/ecc_decode/ecc_decode.py:53"),
    "ssd_intra_chunk": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan/ssd_scan.py:43"),
}
# the phase whose run each kernel's launch count is read around
COUNTED_IN = {"int8_gemv": "serve", "int8_gemm": "serve",
              "paged_decode_attention": "serve", "flash_attention": "serve",
              "ecc_decode": "hybrid", "w4a16_gemv": "serve_w4a16",
              "ssd_intra_chunk": "serve_hybrid"}

# tolerance of the attention kernels against their plain versions: both
# accumulate in float32 and round once to bf16; the float32 sums run in
# another order, so the two round to the same or to adjacent bf16 values.
# The limit is ATTN_ULPS bf16 steps of the reference value (a step is
# 2^-7..2^-8 of it), plus ATTN_ATOL for float32 summation noise on outputs
# near 0 whose bf16 step is finer than that noise
ATTN_ULPS = 2
ATTN_ATOL = 1e-5
ATTN_TOL = f"{ATTN_ULPS} bf16 steps of |ref| + {ATTN_ATOL}"
# card (kernels) vs CPU (plain versions) logits of the reduced model: both
# keep activations in bf16, and bf16 rounds at other places on the two
# devices (rsqrt, exp and the attention sums differ in their last bits; a
# one-step bf16 difference can move an int8 activation code by one).  So
# the yardstick is the bf16 rounding error itself: the CPU's bf16 run is
# compared with a float32 run of the same weights, and the card must stay
# within MODEL_RATIO times that distance of the float32 run at every step
MODEL_RATIO = 1.25
# B4 against its plain version: both dequantize to the same float32 weights
# and sum float32 products in another order, so each output may differ by
# a few float32 roundings of the sum of |products|
W4_REL, W4_ABS = 1e-5, 1e-6
W4_TOL = f"{W4_REL} * (|x| @ |W|^T) + {W4_ABS}"
# B6 against its plain version computed in float64 on the same inputs:
# the JAX package's own B6 tolerance (tests/test_kernels.py).  float64,
# because at the model's decays a chunk's cumulative sum reaches |cs| ~ 2e3,
# where two float32 summation orders differ by ~1e-4 and so move
# L = exp(cs_i - cs_j) by as much as the tolerance; the kernel sums in double
SSD_TOL = 1e-4
HYBRID_BER = 2e-4
# JAX package's examples/quickstart.py on the CPU, 4096x4096 on
# Cambricon-LLM-S: relative errors clean / BER 2e-4 with ECC / without
JAX_YARDSTICK = (0.0120, 0.0344, 0.0539)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, n_bufs: int = 1, iters: int = 20,
            warmup: int = 3) -> float:
    """Median of per-call CUDA-event times; ``fn(i)`` runs call i, cycling
    ``n_bufs`` input sets so a weight-streaming kernel does not find its
    weights in the 50 MB L2 cache."""
    for i in range(warmup):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    times = []
    for i in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i % n_bufs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_ms(torch, fn, names, n_bufs: int = 1, iters: int = 10) -> float:
    """Device time per call (ms) of the kernels named ``names`` under
    torch.profiler, which, unlike ``time_ms``'s events, leaves out the
    host's launch overhead around a short kernel."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i % n_bufs)
        torch.cuda.synchronize()
    total = _device_ms(prof, names)
    return float("nan") if total is None else total / iters


def bound(bytes_moved: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    log(f"[card] nvidia-smi: {line}")
    log(f"[card] torch: {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    return line


def _demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names),
                         stdout=subprocess.PIPE, text=True, check=True)
    return out.stdout.splitlines()


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.monotonic()
    b = build.build()
    build.library()
    log(f"[build] {b.path.name} {'built' if b.built else 'reused'} in "
        f"{time.monotonic() - t0:.1f} s")
    entries, name, spill = [], None, ""
    for line in b.log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            entries.append((name, line.split(":", 1)[-1].strip(), spill))
            name, spill = None, ""
    for pretty, (_n, used, sp) in zip(_demangle([e[0] for e in entries]),
                                      entries):
        short = re.sub(r"\(.*\)$", "", pretty.replace("(anonymous namespace)::", ""))
        log(f"[build] ptxas {short}: {used}; {sp}")


def _bf16_step(torch, ref):
    """Spacing of bf16 values at |ref| (8 significant bits)."""
    mag = ref.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _attn_errors(torch, got, ref):
    """(|err|, its limit) per output."""
    err = (got.float() - ref.float()).abs()
    return err, ATTN_ULPS * _bf16_step(torch, ref) + ATTN_ATOL


def _check_close(torch, name, got, ref):
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    err, limit = _attn_errors(torch, got, ref)
    if not bool((err <= limit).all()):
        raise AssertionError(f"{name}: {int((err > limit).sum())} outputs "
                             f"above {ATTN_TOL}, max |err| "
                             f"{err.max().item():.3e}")
    return err.max().item(), (err / limit).max().item()


def _planted_faults(torch, q, kp, vp, block, lengths, ref, page) -> None:
    """The decode attention kernel run with lane 0 one token short and one
    page short computes what a kernel that skipped that token or page would;
    the comparison with the reference must reject both."""
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention

    live = lengths > 0
    for fault, short in (("one token short", 1), ("one page short", page)):
        bad_len = lengths.clone()
        bad_len[0] -= short
        bad = paged_decode_attention(q, kp, vp, block, bad_len)
        torch.cuda.synchronize()
        err, limit = _attn_errors(torch, bad[live], ref[live])
        caught = int((err > limit).sum())
        r = ref[live].float().abs()
        loose = int((err > 1e-2 + 1e-2 * r).sum())
        log(f"[kernels] planted fault, lane 0 (len {int(lengths[0])}) "
            f"{fault}: max|err| {err.max().item():.3e}; {caught} of "
            f"{err.numel()} outputs above {ATTN_TOL}; {loose} above "
            f"1e-2 + 1e-2*|ref|")
        if caught == 0:
            raise AssertionError(f"planted fault ({fault}) passes the "
                                 f"decode attention check")


def phase_kernels(torch, results: dict) -> None:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.int8_pagegemv.ops import int8_gemm
    from repro_torch.kernels.int8_pagegemv.ref import int8_gemm_ref
    from repro_torch.models.attention import gather_paged_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand_i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    # ---- B2: int8 product, bit-exact --------------------------------------
    # llama2-7b: q/k/v/o 4096x4096, gate/up 4096->11008, down 11008->4096;
    # M = 4 slots at decode, 4 x 512 at prefill; smollm K=960 / 2560;
    # ragged shapes take the masked byte-wise path
    shapes = [(4, 4096, 4096), (4, 4096, 11008), (4, 11008, 4096),
              (2048, 4096, 4096), (2048, 4096, 11008), (2048, 11008, 4096),
              (4, 960, 2560), (2048, 2560, 960), (1, 960, 320),
              (5, 1000, 300), (37, 1000, 130), (3, 64, 128)]
    rep = {"int8_gemv": (4, 4096, 11008), "int8_gemm": (2048, 4096, 11008)}
    for m, k, n in shapes:
        variant = "int8_gemv" if m <= 8 else "int8_gemm"
        x = rand_i8(m, k)
        ws = [rand_i8(n, k) for _ in range(1 if m > 8 else 4)]
        got = int8_gemm(x, ws[0])
        ref = int8_gemm_ref(x, ws[0])
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = (got != ref).sum().item()
            raise AssertionError(f"{variant} M={m} K={k} N={n}: {bad} "
                                 f"entries differ from the exact product")
        line = f"[kernels] {variant} M={m} K={k} N={n}: bit-exact"
        if (m, k, n) == rep[variant]:
            ms = time_ms(torch, lambda i: int8_gemm(x, ws[i]), len(ws))
            dev_ms = profiled_ms(torch, lambda i: int8_gemm(x, ws[i]),
                                 (variant,), len(ws))
            plain = time_ms(torch, lambda i: int8_gemm_ref(x, ws[i]), len(ws))
            lib = None
            if m > 16:  # torch._int_mm takes M > 16 only
                wt = [w.t() for w in ws]
                lib = time_ms(torch, lambda i: torch._int_mm(x, wt[i]),
                              len(ws))
            b_ms, b_by = bound(m * k + n * k + 4 * m * n, 2 * m * n * k,
                               "int8")
            results[variant].update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                                    library_ms=lib,
                                    bound_ms=b_ms, bound_by=b_by,
                                    shape=f"M={m} K={k} N={n}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms), plain "
                     f"{plain:.4f} ms, library "
                     f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
                     f"{b_ms:.4f} ms ({b_by})")
        results[variant]["max_abs_err"] = 0.0
        log(line)

    # ---- B1: paged decode attention ---------------------------------------
    page = 16
    timed = ("llama2-7b", "zamba2-7b")   # the JSON row holds llama2-7b's
    for tag, b, h, hkv, d, max_seq, lens in [
            ("llama2-7b", 4, 32, 32, 128, 1024, [1024, 545, 17, 0]),
            ("zamba2-7b", 4, 32, 32, 112, 1024, [1024, 545, 17, 0]),
            ("smollm-360m", 4, 15, 5, 64, 1024, [700, 64, 1, 0])]:
        pps = max_seq // page
        n_pages = b * pps + 1
        n_bufs = 3
        pools = [(randn(n_pages, page, hkv, d), randn(n_pages, page, hkv, d))
                 for _ in range(n_bufs)]
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev)[:b * pps]
        block = (perm + 1).reshape(b, pps).to(torch.int32).contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = randn(b, h, d)
        kp, vp = pools[0]
        got = paged_decode_attention(q, kp, vp, block, lengths)
        ref = paged_decode_attention_ref(q, kp, vp, block, lengths)
        torch.cuda.synchronize()
        live = lengths > 0
        err, used = _check_close(torch, f"paged_decode_attention[{tag}]",
                                  got[live], ref[live])
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError("length-0 lane is not finite")
        res = results["paged_decode_attention"]
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
        line = (f"[kernels] paged_decode_attention {tag} B={b} H={h} "
                f"Hkv={hkv} D={d} lens={lens}: max|err| {err:.3e} "
                f"(worst |err|/limit {used:.3f}; tol {ATTN_TOL}), length-0 lane "
                f"finite")
        if tag in timed:
            _planted_faults(torch, q, kp, vp, block, lengths, ref, page)
            ms = time_ms(torch, lambda i: paged_decode_attention(
                q, pools[i][0], pools[i][1], block, lengths), n_bufs)
            dev_ms = profiled_ms(torch, lambda i: paged_decode_attention(
                q, pools[i][0], pools[i][1], block, lengths),
                ("paged_decode_attention",), n_bufs)
            plain = time_ms(torch, lambda i: paged_decode_attention_ref(
                q, pools[i][0], pools[i][1], block, lengths), n_bufs)
            # library yardstick: SDPA over the already-gathered cache with
            # a length mask (the gather itself is not timed)
            kd = [gather_paged_rows(p[0], block).transpose(1, 2).contiguous()
                  for p in pools]
            vd = [gather_paged_rows(p[1], block).transpose(1, 2).contiguous()
                  for p in pools]
            mask = (torch.arange(max_seq, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                q4, kd[i], vd[i], attn_mask=mask), n_bufs)
            n_tok = sum(lens)
            bytes_moved = (2 * b * h * d * 2 + n_tok * hkv * d * 2 * 2
                           + block.numel() * 4 + b * 4)
            b_ms, b_by = bound(bytes_moved, 4 * n_tok * h * d, "bf16")
            if tag == "llama2-7b":
                res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                           library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                           shape=f"B={b} H={h} D={d} lens={lens}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms), plain "
                     f"{plain:.4f} ms, SDPA on the gathered cache {lib:.4f} "
                     f"ms, bound {b_ms:.4f} ms ({b_by})")
        log(line)

    # ---- B3: causal prefill flash attention ---------------------------------
    for tag, b, s, h, hkv, d in [("llama2-7b", 4, 512, 32, 32, 128),
                                 ("zamba2-7b", 4, 512, 32, 32, 112),
                                 ("smollm-360m", 4, 512, 15, 5, 64),
                                 ("ragged", 2, 200, 8, 2, 128),
                                 ("reduced", 4, 32, 4, 4, 16)]:
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        got = flash_attention(q, k, v)
        ref = flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err, used = _check_close(torch, f"flash_attention[{tag}]", got, ref)
        res = results["flash_attention"]
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
        line = (f"[kernels] flash_attention {tag} B={b} S={s} H={h} Hkv={hkv} "
                f"D={d}: max|err| {err:.3e} (worst |err|/limit {used:.3f}; tol "
                f"{ATTN_TOL})")
        if tag in timed:
            ms = time_ms(torch, lambda i: flash_attention(q, k, v))
            dev_ms = profiled_ms(torch, lambda i: flash_attention(q, k, v),
                                 ("flash_attention",))
            plain = time_ms(torch, lambda i: flash_attention_ref(q, k, v))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            bytes_moved = (2 * b * s * h * d + 2 * b * s * hkv * d) * 2
            ops = 4 * b * h * d * s * (s + 1) / 2
            b_ms, b_by = bound(bytes_moved, ops, "bf16")
            if tag == "llama2-7b":
                res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                           library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                           shape=f"B={b} S={s} H={h} D={d}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms), plain "
                     f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {b_ms:.4f} "
                     f"ms ({b_by})")
        log(line)

    _kernels_ecc(torch, results)
    _kernels_w4a16(torch, results)
    _kernels_ssd(torch, results)


def _kernels_ecc(torch, results: dict) -> None:
    """B5 against its plain version on 4,096 random int8 pages at three
    BERs, every position; the planted fault (the last sidecar entry's
    restore skipped) must fail."""
    from repro_torch.core import ecc
    from repro_torch.kernels.ecc_decode.ops import ecc_decode

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n = 4096
    res = results["ecc_decode"]
    res["max_abs_err"] = 0.0
    for ber in (0.0, 1e-4, 2e-3):
        pages = torch.randint(0, 256, (n, ecc.PAGE_ELEMS), generator=gen,
                              device=dev, dtype=torch.uint8)
        code = ecc.encode_pages(pages)
        noisy = ecc.inject_bitflips(pages, ber, gen)
        code = ecc.inject_ecc_bitflips(code, ber, gen)
        got = ecc_decode(noisy, code)
        ref = ecc.decode_pages(noisy, code)
        torch.cuda.synchronize()
        addr, _valid = ecc.hamming_correct(code.addr, code.addr_parity)
        srt = torch.sort(addr, dim=1).values
        collisions = int((srt[:, 1:] == srt[:, :-1]).sum())
        bad = int((got != ref).sum())
        fixed = int((ref != noisy).sum())
        if bad:
            raise AssertionError(f"ecc_decode BER {ber:g}: {bad} bytes differ "
                                 f"from the plain decode")
        if ber == 0.0 and not torch.equal(got, pages):
            raise AssertionError("ecc_decode changed clean pages")
        line = (f"[kernels] ecc_decode {n} pages BER {ber:g}: bit-exact on "
                f"every position ({collisions} colliding entries), "
                f"{fixed} bytes corrected")
        if ber == 2e-3:
            short = ecc.PageECC(code.threshold, code.addr[:, :-1].contiguous(),
                                code.addr_parity[:, :-1].contiguous(),
                                code.copies[:, :-1].contiguous())
            caught = int((ecc_decode(noisy, short) != ref).sum())
            log(f"[kernels] planted fault, ecc_decode with the last entry's "
                f"restore skipped: {caught} bytes differ from the plain decode")
            if caught == 0:
                raise AssertionError("planted fault (last restore skipped) "
                                     "passes the ecc_decode check")
            bufs = [noisy, noisy.flip(0).contiguous()]
            codes = [code, ecc.PageECC(*(t.flip(0).contiguous()
                                         for t in code))]
            ms = time_ms(torch, lambda i: ecc_decode(bufs[i], codes[i]), 2)
            dev_ms = profiled_ms(torch, lambda i: ecc_decode(bufs[i], codes[i]),
                                 ("ecc_decode",), 2)
            plain = time_ms(torch, lambda i: ecc.decode_pages(bufs[i],
                                                              codes[i]), 2,
                            iters=5)
            k = code.addr.shape[1]
            bytes_moved = n * (2 * ecc.PAGE_ELEMS + code.threshold.shape[1]
                               + 4 * k + k + 2 * k)
            b_ms, b_by = bound(bytes_moved, 0, "int8")
            res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                       library_ms=None, bound_ms=b_ms,
                       bound_by=b_by, shape=f"B={n} P={ecc.PAGE_ELEMS} K={k}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms), plain "
                     f"{plain:.4f} ms, library n/a (no PyTorch call decodes "
                     f"the sidecar), bound {b_ms:.4f} ms ({b_by})")
        log(line)


def _kernels_w4a16(torch, results: dict) -> None:
    """B4 against its plain version at the llama2-7b lm_head and MLP
    shapes, a ragged K and the tiled variant, within W4_TOL; the planted
    fault (lo/hi nibbles swapped) must fail."""
    from repro_torch.kernels.w4a16_gemv.ops import w4a16_gemm
    from repro_torch.kernels.w4a16_gemv.ref import w4a16_gemm_ref
    from repro_torch.quant.int4 import dequantize4, quantize_weight4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    res = results["w4a16_gemv"]
    res["max_abs_err"] = 0.0

    def check(got, ref, x, q):
        limit = W4_REL * (x.abs() @ dequantize4(q).abs().T) + W4_ABS
        err = (got - ref).abs()
        torch.cuda.synchronize()
        return int((err > limit).sum()), err.max().item(), \
            (err / limit).max().item()

    for m, k, n in [(4, 4096, 32000), (4, 4096, 11008), (4, 960, 2560),
                    (1, 4096, 4096), (20, 4096, 4096)]:
        n_w = 2 if (m, k, n) == (4, 4096, 32000) else 1
        qs = [quantize_weight4(torch.randn((n, k), generator=gen, device=dev)
                               * k ** -0.5) for _ in range(n_w)]
        x = torch.randn((m, k), generator=gen, device=dev)
        got = w4a16_gemm(x, qs[0].w_packed, qs[0].scale)
        ref = w4a16_gemm_ref(x, qs[0].w_packed, qs[0].scale)
        bad, err, used = check(got, ref, x, qs[0])
        if bad:
            raise AssertionError(f"w4a16_gemv M={m} K={k} N={n}: {bad} "
                                 f"outputs above {W4_TOL}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        line = (f"[kernels] w4a16_gemv M={m} K={k} N={n}: max|err| {err:.3e} "
                f"(worst |err|/limit {used:.3f}; tol {W4_TOL})")
        if n_w == 2:
            q = qs[0]
            swapped = ((q.w_packed >> 4) | (q.w_packed << 4)).contiguous()
            bad_f, err_f, _ = check(w4a16_gemm(x, swapped, q.scale), ref,
                                    x, q)
            log(f"[kernels] planted fault, w4a16_gemv with lo/hi nibbles "
                f"swapped: {bad_f} of {ref.numel()} outputs above the "
                f"tolerance, max|err| {err_f:.3e}")
            if bad_f == 0:
                raise AssertionError("planted fault (nibbles swapped) passes "
                                     "the w4a16_gemv check")
            ms = time_ms(torch, lambda i: w4a16_gemm(x, qs[i].w_packed,
                                                     qs[i].scale), n_w)
            dev_ms = profiled_ms(torch, lambda i: w4a16_gemm(
                x, qs[i].w_packed, qs[i].scale), ("w4a16_gemv",), n_w)
            plain = time_ms(torch, lambda i: w4a16_gemm_ref(
                x, qs[i].w_packed, qs[i].scale), n_w)
            ng = q.scale.shape[1]
            bytes_moved = n * k // 2 + n * ng * 4 + m * k * 4 + m * n * 4
            b_ms, b_by = bound(bytes_moved, 2 * m * n * k, "f32")
            res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                       library_ms=None, bound_ms=b_ms,
                       bound_by=b_by, shape=f"M={m} K={k} N={n}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms), plain "
                     f"{plain:.4f} ms, library n/a (no PyTorch call "
                     f"multiplies packed nibbles), bound {b_ms:.4f} ms "
                     f"({b_by})")
        log(line)


def _ssd_inputs(torch, gen, b, s, h, g, p, n):
    """Model-like B6 inputs on the card: x and B / C in bf16, a = -A_h dt
    with A_h = 1..16 over the heads (the model's a_log) and dt =
    softplus(normal), as the model's log decays are made."""
    dev = torch.device("cuda")
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    a = -torch.linspace(1.0, 16.0, h, device=dev) * dt
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device=dev).mul(0.5)
              .to(torch.bfloat16) for _ in range(2))
    return x, a, bm, cm


def _ssd_mask_faults(torch, x, a, bm, cm, chunk, got) -> dict:
    """What a kernel with a wrong causal mask computes: the kernel's own
    output plus the j = i+1 term (mask j <= i+1), or minus the diagonal
    term (mask j < i), in float64."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    nc, rep = s // chunk, h // g
    xr = x.double().reshape(b, nc, chunk, h, p)
    cs = a.double().reshape(b, nc, chunk, h).cumsum(2)
    bh, ch = (m.double().repeat_interleave(rep, dim=2).reshape(
        b, nc, chunk, h, n) for m in (bm, cm))
    diag = (ch * bh).sum(-1)[..., None] * xr
    sup = torch.zeros_like(xr)
    sup[:, :, :-1] = ((ch[:, :, :-1] * bh[:, :, 1:]).sum(-1)
                      * torch.exp(cs[:, :, :-1] - cs[:, :, 1:]))[..., None] \
        * xr[:, :, 1:]
    base = got.double()
    return {"j <= i+1 admitted": base + sup.reshape(b, s, h, p),
            "diagonal dropped": base - diag.reshape(b, s, h, p)}


def _kernels_ssd(torch, results: dict) -> None:
    """B6 against its plain version (float64) at the zamba2-7b and
    mamba2-130m prefill shapes (bucket 512, Q 128), the smallest bucket
    (Q 8) and two B/C groups, within SSD_TOL; two planted mask faults must
    fail.  Timed at the zamba2-7b shape."""
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_model_ref

    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(6)
    res = results["ssd_intra_chunk"]
    res["max_abs_err"] = 0.0
    tol = f"rtol = atol = {SSD_TOL} against the float64 plain version"
    for tag, b, s, h, g, p, n, chunk in [
            ("zamba2-7b", 4, 512, 112, 1, 64, 64, 128),
            ("mamba2-130m", 4, 512, 24, 1, 64, 128, 128),
            ("Q 8", 4, 8, 8, 1, 16, 16, 8),
            ("G 2", 2, 256, 16, 2, 32, 64, 64)]:
        n_bufs = 2 if tag == "zamba2-7b" else 1
        ins = [_ssd_inputs(torch, gen, b, s, h, g, p, n)
               for _ in range(n_bufs)]
        x, a, bm, cm = ins[0]
        got = ssd_intra_chunk(x, a, bm, cm, chunk)
        ref = ssd_intra_chunk_model_ref(x, a, bm, cm, chunk, torch.float64)
        ref32 = ssd_intra_chunk_model_ref(x, a, bm, cm, chunk)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"ssd_intra_chunk[{tag}]: non-finite output")
        limit = SSD_TOL + SSD_TOL * ref.abs()
        err = (got.double() - ref).abs()
        if not bool((err <= limit).all()):
            raise AssertionError(
                f"ssd_intra_chunk[{tag}]: {int((err > limit).sum())} outputs "
                f"beyond {tol}, max |err| {err.max().item():.3e}")
        err32 = (ref32.double() - ref).abs()
        res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
        line = (f"[kernels] ssd_intra_chunk {tag} B={b} S={s} H={h} G={g} "
                f"P={p} N={n} Q={chunk}: max|err| {err.max().item():.3e} "
                f"(worst |err|/limit {(err / limit).max().item():.3f}; tol "
                f"{tol}); the float32 plain version's own max|err| "
                f"{err32.max().item():.3e} (|err|/limit "
                f"{(err32 / limit).max().item():.3f}), kernel vs it "
                f"{(got - ref32).abs().max().item():.3e}")
        if tag == "zamba2-7b":
            for fault, bad in _ssd_mask_faults(torch, x, a, bm, cm, chunk,
                                               got).items():
                e = (bad - ref).abs()
                caught = int((~(e <= limit)).sum())
                log(f"[kernels] planted fault, ssd_intra_chunk with the mask "
                    f"{fault}: {caught} of {e.numel()} outputs beyond the "
                    f"tolerance")
                if caught == 0:
                    raise AssertionError(f"planted fault ({fault}) passes the "
                                         f"ssd_intra_chunk check")
            ms = time_ms(torch, lambda i: ssd_intra_chunk(*ins[i], chunk),
                         n_bufs)
            dev_ms = profiled_ms(torch, lambda i: ssd_intra_chunk(
                *ins[i], chunk), ("ssd_intra_chunk",), n_bufs)
            plain = time_ms(torch, lambda i: ssd_intra_chunk_model_ref(
                *ins[i], chunk), n_bufs, iters=10)
            # each input read once, y written once; Q(Q+1)/2 (N + P)
            # multiply-adds per (batch, head, chunk): the causal half
            bytes_moved = (b * s * h * p * 2 + b * s * h * 4
                           + 2 * b * s * g * n * 2 + b * s * h * p * 4)
            ops = 2 * b * h * (s // chunk) * chunk * (chunk + 1) // 2 * (n + p)
            b_ms, b_by = bound(bytes_moved, ops, "f32")
            res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       shape=f"B={b} S={s} H={h} G={g} P={p} N={n} Q={chunk}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms), plain "
                     f"{plain:.4f} ms, library n/a (no PyTorch call computes "
                     f"the decay-masked product), bound {b_ms:.4f} ms "
                     f"({b_by}: {ops / 1e9:.2f} GFLOP, "
                     f"{bytes_moved / 1e6:.1f} MB)")
        log(line)


def _to_runs(torch, params_cpu) -> dict:
    """The same W8A8 weights three ways: card bf16 (kernels), CPU bf16
    (plain versions), CPU float32 (plain versions, the yardstick)."""
    def to(tree, dev, f32=False):
        if isinstance(tree, dict):
            return {k: to(v, dev, f32) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev, f32) for v in tree]
        if tree is None:
            return None
        if f32 and tree.dtype == torch.bfloat16:
            tree = tree.float()
        return tree.to(dev)

    return {"cpu": (params_cpu, "cpu", torch.bfloat16),
            "cuda": (to(params_cpu, "cuda"), "cuda", torch.bfloat16),
            "f32": (to(params_cpu, "cpu", f32=True), "cpu", torch.float32)}


def _ratio_gate(torch, tag: str, logits: dict) -> None:
    """At every step the card's logits must lie within MODEL_RATIO x the
    CPU bf16 run's own distance from the float32 run."""
    worst_ratio, worst_card_cpu = 0.0, 0.0
    for i in range(len(logits["cpu"])):
        card, cpu, ref = (logits[k][i] for k in ("cuda", "cpu", "f32"))
        step = "prefill" if i == 0 else f"decode {i}"
        if not bool(torch.isfinite(card).all()):
            raise AssertionError(f"model {tag} {step}: non-finite card logits")
        card_cpu = (card - cpu).abs().max().item()
        card_f32 = (card - ref).abs().max().item()
        cpu_f32 = (cpu - ref).abs().max().item()
        ratio = card_f32 / max(cpu_f32, 1e-30)
        worst_ratio = max(worst_ratio, ratio)
        worst_card_cpu = max(worst_card_cpu, card_cpu)
        log(f"[model] {tag} {step}: max|dlogit| card-CPU {card_cpu:.3e}, "
            f"card-f32 {card_f32:.3e}, CPU-f32 {cpu_f32:.3e}, ratio "
            f"{ratio:.3f} (|logit| max {ref.abs().max().item():.2f})")
        if ratio > MODEL_RATIO:
            raise AssertionError(
                f"model {tag} {step}: card bf16 logits are {card_f32:.3e} "
                f"from float32, more than {MODEL_RATIO} x the CPU bf16 run's "
                f"{cpu_f32:.3e}")
    log(f"[model] {tag} W8A8: at every step the card is within "
        f"{MODEL_RATIO} x the CPU's own bf16 distance from the float32 run "
        f"(worst ratio {worst_ratio:.3f}); card vs CPU {worst_card_cpu:.3e}")


def _model_paged(torch, arch: str) -> None:
    """prefill_into_slots and four decode steps of ``arch``.reduced(), W8A8,
    card against CPU against float32."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.quant.convert import quantize_params

    cfg = get_arch(arch).reduced()
    runs = _to_runs(torch, quantize_params(M.init_params(cfg, seed=1,
                                                         device="cpu")))
    prompts = [[int(t) for t in torch.randint(
        0, cfg.vocab_size, (n,), generator=torch.Generator().manual_seed(n))]
        for n in (37, 64, 5)]
    bucket, slots, max_seq, page = 64, 4, 128, 16
    toks = torch.tensor([p + [0] * (bucket - len(p)) for p in prompts]
                        + [prompts[0] + [0] * (bucket - len(prompts[0]))],
                        dtype=torch.int32)
    tl = torch.tensor([len(p) for p in prompts] + [len(prompts[0])],
                      dtype=torch.int32)
    sid = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    pps = max_seq // page
    block = torch.arange(1, slots * pps + 1, dtype=torch.int32).reshape(
        slots, pps)
    logits, caches = {}, {}
    for name, (params, dev, dtype) in runs.items():
        cache = M.init_paged_cache(cfg, slots, max_seq, dtype=dtype,
                                   page_size=page, device=dev)
        cache["block"] = block.to(dev)
        lg, caches[name] = M.prefill_into_slots(
            params, cfg, toks.to(dev), tl.to(dev), cache, sid.to(dev))
        logits[name] = [lg[:3].float().cpu()]
    active = torch.tensor([True, True, True, False])
    for _ in range(4):   # teacher-forced with the CPU run's greedy tokens
        tok = torch.cat([torch.argmax(logits["cpu"][-1], -1).to(torch.int32),
                         torch.zeros(1, dtype=torch.int32)])
        for name, (params, dev, _dtype) in runs.items():
            lg, caches[name] = M.decode_step_paged(
                params, cfg, tok.to(dev), caches[name], active.to(dev))
            logits[name].append(lg[:3].float().cpu())
    torch.cuda.synchronize()
    _ratio_gate(torch, f"{arch}.reduced()", logits)


def _model_forward(torch, arch: str, batch: int, seq: int) -> None:
    """``forward`` of ``arch`` at full width, W8A8, on ``batch`` x ``seq``
    tokens: card against CPU against float32."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.quant.convert import quantize_params

    cfg = get_arch(arch)
    runs = _to_runs(torch, quantize_params(M.init_params(cfg, seed=2,
                                                         device="cpu")))
    toks = torch.randint(0, cfg.vocab_size, (batch, seq),
                         generator=torch.Generator().manual_seed(3))
    t0 = time.monotonic()
    logits = {name: [M.forward(params, cfg, toks.to(dev)).float().cpu()]
              for name, (params, dev, _dtype) in runs.items()}
    torch.cuda.synchronize()
    log(f"[model] {arch} full width W8A8 forward on {batch} x {seq} tokens, "
        f"three runs in {time.monotonic() - t0:.1f} s")
    _ratio_gate(torch, f"{arch} forward", logits)
    # the same forward unquantized in float32 on both devices: what is left
    # is float32 summation order (and B6's double-precision decays)
    p32 = M.init_params(cfg, seed=2, device="cpu", dtype=torch.float32)
    cpu = M.forward(p32, cfg, toks)
    card = M.forward(_to_runs(torch, p32)["cuda"][0], cfg,
                     toks.to("cuda")).cpu()
    log(f"[model] {arch} full width float32 forward: max|dlogit| card-CPU "
        f"{(card - cpu).abs().max().item():.3e} (|logit| max "
        f"{cpu.abs().max().item():.2f})")


def phase_model(torch) -> None:
    _model_paged(torch, "llama2-7b")
    _model_paged(torch, "zamba2-7b")
    _model_forward(torch, "mamba2-130m", 2, 256)


def _serve_full(torch, arch: str, tag: str, smi: str) -> tuple[dict, object]:
    """``arch`` at full width, W8A8, through launch/serve.py's build_client:
    4 slots, max_seq 1024, page 16, 8 greedy requests with 64-512-token
    prompts and 32 new tokens each.  Every launch counter is zeroed before
    the run and read after; returns the counts and the client."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch.serve import build_client
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg, client = build_client(arch, reduced=False, quant="w8a8",
                               max_batch=4, max_seq=1024, seed=0,
                               device="cuda")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    log(f"[{tag}] {arch} full width W8A8 built in "
        f"{time.monotonic() - t0:.1f} s, {resident:.2f} GiB allocated "
        f"(weights and cache), build peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    core = client.router.cores[0]
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in rng.randint(64, 513, size=8)]

    # a direct prefill of the first prompt, outside the engine, as the
    # reference for the engine's first token of that request
    ref_cache = M.init_paged_cache(cfg, 1, 1024, device="cuda")
    ref_cache["block"] = torch.arange(1, 65, dtype=torch.int32,
                                      device="cuda")[None]
    p0 = prompts[0]
    ref_logits, _ = M.prefill_into_slots(
        core.params, cfg, torch.tensor([p0], device="cuda"),
        torch.tensor([len(p0)], device="cuda"), ref_cache,
        torch.tensor([0], device="cuda"))
    if ref_logits.shape != (1, cfg.vocab_size) \
            or not bool(torch.isfinite(ref_logits).all()):
        raise AssertionError("reference prefill logits malformed")
    top2 = torch.topk(ref_logits[0], 2).values
    ref_tok = int(torch.argmax(ref_logits[0]))
    margin = float(top2[0] - top2[1])
    del ref_cache

    handles = [client.submit(p, max_new_tokens=32) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    client.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    stats = core.stats
    for h in handles:
        toks = h.request.out_tokens
        if not h.finished or h.finish_reason != "length" or len(toks) != 32:
            raise AssertionError(f"request {h.rid}: finished={h.finished} "
                                 f"reason={h.finish_reason} n={len(toks)}")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {h.rid}: token out of range")
    first = handles[0].request.out_tokens[0]
    log(f"[{tag}] direct prefill of request 0: token {ref_tok} (top-2 "
        f"margin {margin:.4f}); engine's first token {first}")
    if margin > 1e-3 and first != ref_tok:
        raise AssertionError("engine's first token disagrees with a direct "
                             "prefill of the same prompt")
    decode_tokens = stats.tokens_out - len(handles)
    log(f"[{tag}] 8 requests x 32 tokens: tokens_out={stats.tokens_out} "
        f"prefills={stats.prefills} decode_steps={stats.decode_steps} "
        f"wall {wall:.2f} s")
    log(f"[{tag}] prefill {stats.wall_prefill_s * 1e3:.1f} ms total "
        f"({stats.wall_prefill_s * 1e3 / max(stats.prefills, 1):.1f} ms per "
        f"group of 4 prompts); decode {decode_tokens} tokens in "
        f"{stats.wall_decode_s:.3f} s = "
        f"{decode_tokens / stats.wall_decode_s:.2f} tok/s "
        f"({stats.wall_decode_s * 1e3 / max(stats.decode_steps, 1):.2f} ms "
        f"per step of 4 slots) on {smi}")
    log(f"[{tag}] peak memory during the run "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on {smi}; "
        f"launches {counts}")
    missing = [k for k, phase in COUNTED_IN.items()
               if phase == tag and counts[k] <= 0]
    missing += [k for k in ("int8_gemv", "int8_gemm",
                            "paged_decode_attention", "flash_attention")
                if counts[k] <= 0 and k not in missing]
    if missing:
        raise AssertionError(f"the serving path never launched {missing}")
    return counts, client


def phase_serve(torch, smi: str) -> tuple[dict, object]:
    return _serve_full(torch, "llama2-7b", "serve", smi)


def phase_serve_hybrid(torch, smi: str) -> dict:
    """zamba2-7b at full width through the serving stack, then where its
    decode step's time goes."""
    import gc

    counts, client = _serve_full(torch, "zamba2-7b", "serve_hybrid", smi)
    phase_profile(torch, client, smi, "serve_hybrid")
    del client
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_profile(torch, client, smi: str, tag: str = "profile") -> None:
    """Where a decode step's time goes: torch.profiler over 6 decode steps
    of 4 slots on a serve phase's engine (after its run), device kernel
    time against the host's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    rng = __import__("numpy").random.RandomState(1)
    for _ in range(4):
        client.submit([int(t) for t in rng.randint(0, 32000, 256)],
                      max_new_tokens=10)
    client.pump()  # admission + prefill + first decode step
    torch.cuda.synchronize()
    steps = 6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            client.pump()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    client.run()
    rows = []  # device kernels only: a CPU op's "self device time" repeats them
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    launches = sum(r[2] for r in rows) / steps
    log(f"[{tag}] profile of {steps} decode steps of 4 slots: wall "
        f"{wall * 1e3 / steps:.2f} ms/step (profiled), {launches:.0f} kernel "
        f"launches/step, device kernels {busy * 1e3 / steps:.2f} ms/step, "
        f"device busy {100 * busy / wall:.1f}% of wall on {smi}")
    if busy <= 0:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    for dev_us, key, count in rows[:8]:
        log(f"[{tag}]   {dev_us / 1e3 / steps:8.3f} ms/step  "
            f"{count // steps:5d} calls/step  {key[:90]}")


def _device_ms(prof, names) -> float | None:
    """Summed device time (ms) of the kernels whose names contain one of
    ``names``, from a torch.profiler run; None if it recorded none."""
    total = 0.0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and \
                any(n in ev.key for n in names):
            total += getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
    return total / 1e3 if total > 0 else None


def phase_hybrid(torch) -> dict:
    """The hybrid NPU+flash GeMV over every matrix of llama2-7b at full
    width, then the ECC resilience study at full width.  Returns the launch
    counts of the one-token sweep."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.hw import CAMBRICON_LLM_S
    from repro_torch.core.hybrid_gemv import (_to_pages, corrupt_flash_region,
                                              decoded_flash, hybrid_gemv,
                                              plan_and_quantize)
    from repro_torch.examples.ecc_resilience import run as resilience
    from repro_torch.kernels.ecc_decode.ops import ecc_decode
    from repro_torch.kernels.int8_pagegemv.ops import int8_gemm, paged_int8_gemm
    from repro_torch.kernels.int8_pagegemv.ref import paged_int8_gemm_ref
    from repro_torch.quant.int8 import quantize_activation

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_arch("llama2-7b")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    layer = [(d, d)] * 4 + [(f, d), (f, d), (d, f)]   # q k v o gate up down
    shapes = layer * cfg.n_layers + [(v, d)]          # + lm_head, [out, in]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    t0 = time.monotonic()
    mats, rel = [], {}
    for h, w in shapes:
        W = torch.randn((h, w), generator=gen, device=dev) * w ** -0.5
        x = torch.randn((w,), generator=gen, device=dev)
        ref = W @ x
        hw = plan_and_quantize(W, CAMBRICON_LLM_S, with_ecc=True)
        del W
        clean = hybrid_gemv(hw, x)
        noisy = corrupt_flash_region(hw, HYBRID_BER, gen)
        del hw
        mats.append((noisy, x, ref))
        r = rel.setdefault(f"{h}x{w}", [[], [], []])
        r[0].append(float(torch.linalg.norm(clean - ref)
                          / torch.linalg.norm(ref)))
    torch.cuda.synchronize()
    flash_pages = sum(m[0].ecc.addr.shape[0] for m in mats)
    flash_bytes = sum(m[0].flash_wq.numel() for m in mats)
    total_bytes = flash_bytes + sum(m[0].npu_wq.numel() for m in mats)
    log(f"[hybrid] llama2-7b full width: {len(mats)} matrices planned on "
        f"Cambricon-LLM-S, quantized, ECC-encoded and corrupted at BER "
        f"{HYBRID_BER:g} in {time.monotonic() - t0:.1f} s; flash region "
        f"{flash_bytes / 1e9:.3f} of {total_bytes / 1e9:.3f} GB "
        f"({100 * flash_bytes / total_bytes:.1f}%), {flash_pages} pages")

    # the main path: one token through every matrix, kernels counted
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ys = [hybrid_gemv(noisy, x) for noisy, x, _ in mats]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"[hybrid] one-token sweep launches {counts}")
    for k in ("ecc_decode", "int8_gemv"):
        if counts[k] <= 0:
            raise AssertionError(f"the hybrid sweep never launched {k}")

    # gates against the plain path on the same corrupted pages
    page_diff = acc_diff = y_diff = 0
    for (noisy, x, ref), y in zip(mats, ys):
        dec_k = decoded_flash(noisy, use_kernel=True)
        dec_p = decoded_flash(noisy, use_kernel=False)
        page_diff += int((dec_k != dec_p).sum())
        x_q, _ = quantize_activation(x[:, None])
        w_k = torch.cat([dec_k, noisy.npu_wq])
        w_p = torch.cat([dec_p, noisy.npu_wq])
        acc_diff += int((paged_int8_gemm(w_k, x_q)
                         != paged_int8_gemm_ref(w_p, x_q)).sum())
        y_diff += int((y != hybrid_gemv(noisy, x, use_kernel=False)).sum())
        raw = hybrid_gemv(noisy._replace(ecc=None), x)
        r = rel[f"{ref.shape[0]}x{x.shape[0]}"]
        r[1].append(float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref)))
        r[2].append(float(torch.linalg.norm(raw - ref)
                          / torch.linalg.norm(ref)))
    torch.cuda.synchronize()
    log(f"[hybrid] against the plain path on the same corrupted pages: "
        f"{page_diff} decoded bytes, {acc_diff} int32 accumulators, "
        f"{y_diff} outputs differ")
    if page_diff or acc_diff or y_diff:
        raise AssertionError("the hybrid kernel path differs from the plain "
                             "path")
    for shape, (c, e, r) in rel.items():
        log(f"[hybrid] rel. error {shape:>11} ({len(c):3d} matrices): clean "
            f"{statistics.mean(c):.4f}, BER {HYBRID_BER:g} with ECC "
            f"{statistics.mean(e):.4f}, without ECC {statistics.mean(r):.4f}")
    log(f"[hybrid] JAX package on the CPU (examples/quickstart.py, 4096x4096 "
        f"on Cambricon-LLM-S): clean {JAX_YARDSTICK[0]:.4f}, with ECC "
        f"{JAX_YARDSTICK[1]:.4f}, without ECC {JAX_YARDSTICK[2]:.4f}")
    worse = [s for s, (_c, e, r) in rel.items()
             if statistics.mean(e) > statistics.mean(r)]
    if worse:
        raise AssertionError(f"ECC made the hybrid GeMV worse at {worse}")

    # device time of one full sweep: B5 over every flash page, B2 over both
    # regions of every matrix (activations quantized beforehand)
    pages = [_to_pages(m[0].flash_wq) for m in mats]
    xqs = [quantize_activation(m[1])[0][None].contiguous() for m in mats]
    for _ in range(2):   # warm up
        for (noisy, _x, _r), pg, xq in zip(mats, pages, xqs):
            ecc_decode(pg, noisy.ecc)
            int8_gemm(xq, noisy.flash_wq)
            int8_gemm(xq, noisy.npu_wq)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for (noisy, _x, _r), pg, xq in zip(mats, pages, xqs):
            ecc_decode(pg, noisy.ecc)
            int8_gemm(xq, noisy.flash_wq)
            int8_gemm(xq, noisy.npu_wq)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    b5 = _device_ms(prof, ("ecc_decode",))
    b2 = _device_ms(prof, ("int8_gemv",))
    b5_bound = flash_pages * (2 * 16384 + 9 + 7 * 163) / HBM_BYTES_PER_S * 1e3
    b2_bound = total_bytes / HBM_BYTES_PER_S * 1e3
    fmt = lambda t: "not measured" if t is None else f"{t:.3f} ms"  # noqa: E731
    log(f"[hybrid] one sweep over {len(mats)} matrices (torch.profiler device "
        f"time): B5 ecc_decode {fmt(b5)} (bound {b5_bound:.3f} ms, "
        f"{flash_pages} pages), B2 int8_gemv {fmt(b2)} over "
        f"{2 * len(mats)} launches (bound {b2_bound:.3f} ms, "
        f"{total_bytes / 1e9:.3f} GB); host wall {wall * 1e3:.1f} ms")
    del mats, ys, pages, xqs
    gc.collect()
    torch.cuda.empty_cache()

    # ECC resilience at full width, W8A8
    t0 = time.monotonic()
    (ber, a_ecc, a_raw), = resilience(
        "llama2-7b", reduced=False, device="cuda", seed=0, bers=(HYBRID_BER,),
        dtype=torch.bfloat16)
    log(f"[hybrid] ecc_resilience llama2-7b full width W8A8, 4x24 tokens, "
        f"BER {ber:g}: top-1 agreement with ECC {a_ecc:.1%}, without ECC "
        f"{a_raw:.1%} ({time.monotonic() - t0:.1f} s)")
    if a_ecc < a_raw:
        raise AssertionError("ECC's top-1 agreement is below the raw one")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_serve_w4a16(torch) -> dict:
    """llama2-7b at full width with a W4A16 lm_head (W8A8 layers) through
    launch/serve.py's build_client; returns the launch counts of the run."""
    import gc

    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch.serve import build_client
    from repro_torch.models import model as M

    t0 = time.monotonic()
    cfg, client = build_client("llama2-7b", reduced=False, quant="w4a16",
                               max_batch=4, max_seq=512, seed=1,
                               device="cuda")
    torch.cuda.synchronize()
    core = client.router.cores[0]
    if set(core.params["lm_head"]) != {"w_p4", "scale4"}:
        raise AssertionError("the W4A16 model's lm_head is not W4A16")
    log(f"[serve_w4a16] llama2-7b full width, W8A8 layers + W4A16 lm_head, "
        f"built in {time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in rng.randint(32, 257, size=4)]
    ref_cache = M.init_paged_cache(cfg, 1, 512, device="cuda")
    ref_cache["block"] = torch.arange(1, 33, dtype=torch.int32,
                                      device="cuda")[None]
    p0 = prompts[0]
    ref_logits, _ = M.prefill_into_slots(
        core.params, cfg, torch.tensor([p0], device="cuda"),
        torch.tensor([len(p0)], device="cuda"), ref_cache,
        torch.tensor([0], device="cuda"))
    top2 = torch.topk(ref_logits[0], 2).values
    ref_tok = int(torch.argmax(ref_logits[0]))
    margin = float(top2[0] - top2[1])
    del ref_cache
    handles = [client.submit(p, max_new_tokens=16) for p in prompts]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    client.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    for h in handles:
        toks = h.request.out_tokens
        if not h.finished or h.finish_reason != "length" or len(toks) != 16 \
                or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {h.rid}: finished={h.finished} "
                                 f"reason={h.finish_reason} n={len(toks)}")
    first = handles[0].request.out_tokens[0]
    stats = core.stats
    log(f"[serve_w4a16] 4 requests x 16 tokens in {wall:.2f} s "
        f"(decode {stats.wall_decode_s * 1e3 / max(stats.decode_steps, 1):.2f}"
        f" ms per step); direct prefill's token {ref_tok} (top-2 margin "
        f"{margin:.4f}), engine's first token {first}; launches {counts}")
    if margin > 1e-3 and first != ref_tok:
        raise AssertionError("engine's first token disagrees with a direct "
                             "prefill of the same prompt")
    missing = [k for k in ("w4a16_gemv", "int8_gemv", "int8_gemm",
                           "paged_decode_attention", "flash_attention")
               if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the W4A16 serving path never launched "
                             f"{missing}")
    del client, core
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="card,build,kernels,model,serve,profile,hybrid,"
                            "serve_w4a16,serve_hybrid")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    smi_line = phase_card(torch)
    if "build" in phases:
        phase_build()
    results = {name: {} for name in SOURCES}
    if "kernels" in phases:
        phase_kernels(torch, results)
    if "model" in phases:
        phase_model(torch)
    # launch counts are read only around each owning phase's run
    counts: dict[str, dict] = {}
    if "serve" in phases:
        counts["serve"], client = phase_serve(torch, smi_line)
        if "profile" in phases:
            phase_profile(torch, client, smi_line)
        del client
        __import__("gc").collect()
        torch.cuda.empty_cache()
    if "hybrid" in phases:
        counts["hybrid"] = phase_hybrid(torch)
    if "serve_w4a16" in phases:
        counts["serve_w4a16"] = phase_serve_w4a16(torch)
    if "serve_hybrid" in phases:
        counts["serve_hybrid"] = phase_serve_hybrid(torch, smi_line)
    rows = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        launches = counts.get(COUNTED_IN[name], {}).get(name)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": r.get("max_abs_err"),
                     "ms": r.get("ms"), "device_ms": r.get("device_ms"),
                     "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"),
                     "bound_by": r.get("bound_by"),
                     "library_ms": r.get("library_ms"),
                     "shape": r.get("shape")})
    log(json.dumps({"kernels": rows}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
