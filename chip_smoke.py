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
            shapes and zamba2-7b's (in_proj K 3584 -> N 14576, out_proj K
            7168 -> N 3584, the shared block's head dim 112): the int8
            product bit-exact in all four variants (the tensor-core GeMV at
            every decode shape and M = 1..8, M = 9 and 130 too), the
            attention kernels within two bf16 steps of the reference;
            planted faults must fail those checks: decode attention given
            a long lane one token or one page short, or every lane's last
            split of 64 keys dropped (D 128 and D 112), B3 with its causal
            mask admitting key i+1 or its last K/V block dropped, B2's GEMM
            with its last 128-byte K stage and the GeMV with its last
            64-byte K slab skipped.  Decode attention is also checked at
            the split edges (lengths 1, 63, 64, 65, 1024) and for a
            slot's bits alone, in its batch and under a wider block table.
            B6 (ssd_intra_chunk)
            at the zamba2-7b and mamba2-130m prefill shapes, Q 8, G 2, Q 64
            with 22 heads (a ragged last head block) and Q 40 with N 24,
            against its plain version in float64 within rtol = atol =
            1e-4; two planted mask faults (j <= i+1 admitted, the diagonal
            dropped) and, at G 2, every head given group 0's C B^T must
            fail.  Its bound counts the function's least work (C B^T once
            per batch, group and chunk) on the bf16 tensor cores.
            Times each (CUDA events, median), its plain version and one
            PyTorch library call where one exists, beside the least time
            the card could take (bytes at 3.35 TB/s or operations at the
            H100's peak, whichever is larger), and the device time
            torch.profiler records, without the host's launch overhead (for
            the library call: every device kernel in its profiled window);
            beside B5 and B6, a PyTorch copy that moves the same bytes.
            The GeMV at five decode shapes (llama2-7b's three, zamba2-7b's
            in_proj and out_proj), its yardstick torch._int_mm on x
            zero-padded to 24 rows; decode attention also at the serve
            trace's own lengths.  B2's __dp4a kernels, which the wrapper
            takes only for a K that is not a multiple of 16 or a misaligned
            base, are held bit-exact at both and timed through the wrapper
            at K 4104.  The host time of one launch is measured for B2's
            tensor-core GEMM, B3, the GeMV and B1, each through its
            wrapper, and the B2 variants through their C entries.
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
6. profile  torch.profiler over one admitted group of 4 prompts (bucket
            512) of the same engine: device ms per group of B2's GEMM, B3,
            B6 and the rest, and launches per group; then over 6 decode
            steps: device kernel time per step against the host's wall
            clock, per step by kernel (B1, the GeMV, the rest, with their
            launches), and the kernels that take it.
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
            leaf corrupted (and decoded by B5), forward on 4 x 24 tokens
            (B2's tensor-core GEMM, counted: B5 and it > 0); the top-1
            agreement with ECC must not be below the raw one.
8. serve_w4a16  llama2-7b at full width through build_client(quant=
            "w4a16") (W8A8 layers, W4A16 lm_head, as the JAX convert
            makes them): 4 greedy requests; all complete, the first token
            equals a direct prefill's, and B4's GeMV launched.
9. serve_hybrid  zamba2-7b at full width (81 Mamba-2 layers, the shared
            attention block after every 6), W8A8, through build_client:
            4 slots, max_seq 1024, page 16, 8 greedy requests with
            64-512-token prompts, 32 new tokens each.  All complete, the
            first token equals a direct prefill's, and B6, B1, B2 and B3
            launched; then torch.profiler over one prefill group and 6
            decode steps, as the profile phase does for llama2-7b.
10. serve_hybrid_w4a16  zamba2-7b at full width through build_client(
            quant="w4a16") (the shared block's seven linears and the
            lm_head W4A16, the Mamba layers W8A8, as the JAX convert makes
            them): 4 slots, page 16, 4 greedy requests of 64-512 tokens, 16
            new tokens each.  All complete, the first token equals a direct
            prefill's, both B4 variants (the GeMV at decode, the tiled GEMM
            at prefill) and B6 launched, no off-path kernel; then the
            prefill and decode profiles, B4's device ms by variant.

The kernels phase also holds B5 (ecc_decode) against its plain version,
with a planted fault that must fail (the last sidecar entry's restore
skipped), on one page and on pages with planted colliding entries; and B4
(w4a16_gemv for M <= 8, w4a16_gemm above) within W4_TOL at W4_SHAPES in
bf16 and float32 x (zamba2-7b's shared block and lm_head at M 4 and 2048,
llama2-7b's lm_head and MLP, ragged M, N and K), with three planted faults
that must fail (lo/hi nibbles swapped, each group's partial scaled by the
next group's scale, the tiled variant's last K tile skipped), a row's bits
the same at M = 1..8, and timed beside its bound on the bf16 tensor cores
(3x the operations for float32 x) and torch._weight_int4pack_mm, a
yardstick that rounds the scales and the output to bf16.

The last three lines are the kernels JSON, nvidia-smi's line and
``{"ok": true, "device": {...}}``; each kernel's ``launches`` is read
around the run of the phase that owns it (serve for B1-B3, hybrid for
B5, serve_hybrid_w4a16 for B4's two variants, serve_hybrid for B6).  B2's __dp4a GeMV and
tiled GEMM (``int8_gemv_dp4a``, ``int8_gemm``) are on no model's path
(every model K is a multiple of 16 and every base aligned): a serving
phase that launches either fails.  Any failure
raises and the script exits non-zero; without a CUDA device, or without the
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
    "int8_gemv_dp4a": ("src/repro_torch/kernels/csrc/int8_gemm.cu",
                       "src/repro/kernels/int8_pagegemv/int8_pagegemv.py:40"),
    "int8_gemm": ("src/repro_torch/kernels/csrc/int8_gemm.cu",
                  "src/repro/kernels/int8_pagegemv/int8_pagegemv.py:40"),
    "int8_gemm_tc": ("src/repro_torch/kernels/csrc/int8_gemm.cu",
                     "src/repro/kernels/int8_pagegemv/int8_pagegemv.py:40"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:61"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:59"),
    "w4a16_gemv": ("src/repro_torch/kernels/csrc/w4a16_gemv.cu",
                   "src/repro/kernels/w4a16_gemv/w4a16_gemv.py:43"),
    "w4a16_gemm": ("src/repro_torch/kernels/csrc/w4a16_gemv.cu",
                   "src/repro/kernels/w4a16_gemv/w4a16_gemv.py:43"),
    "ecc_decode": ("src/repro_torch/kernels/csrc/ecc_decode.cu",
                   "src/repro/kernels/ecc_decode/ecc_decode.py:53"),
    "ssd_intra_chunk": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan/ssd_scan.py:43"),
}
# the phase whose run each kernel's launch count is read around
COUNTED_IN = {"int8_gemv": "serve", "int8_gemv_dp4a": "serve",
              "int8_gemm": "serve", "int8_gemm_tc": "serve",
              "paged_decode_attention": "serve", "flash_attention": "serve",
              "ecc_decode": "hybrid", "w4a16_gemv": "serve_hybrid_w4a16",
              "w4a16_gemm": "serve_hybrid_w4a16",
              "ssd_intra_chunk": "serve_hybrid"}
# kept for shapes no model has (K not a multiple of 16, a misaligned base):
# a serving path must not launch them
OFF_PATH = ("int8_gemm", "int8_gemv_dp4a")
# the device kernels (by name, as torch.profiler reports them) behind each
# wrapper; B1's wrapper launches a split and a combine kernel
KERNEL_NAMES = {"int8_gemv": "int8_gemv_mma_kernel",
                "int8_gemv_dp4a": "int8_gemv_dp4a_kernel",
                "int8_gemm": "int8_gemm_kernel",
                "int8_gemm_tc": "int8_gemm_tc_kernel",
                "paged_decode_attention": "paged_decode_attention_",
                "w4a16_gemv": "w4a16_gemv_mma_kernel",
                "w4a16_gemm": "w4a16_gemm_"}
# the kernels every W8A8 serving phase must go through
SERVING_KERNELS = ("int8_gemv", "int8_gemm_tc", "paged_decode_attention",
                   "flash_attention")

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


def profiled_ms(torch, fn, names=None, n_bufs: int = 1,
                iters: int = 10, tries: int = 3) -> float:
    """Device time per call (ms) of the kernels named ``names`` (None:
    every device kernel in the window) under torch.profiler, which, unlike
    ``time_ms``'s events, leaves out the host's launch overhead around a
    short kernel.  A window whose kernel records are not a whole number per
    call (the profiler dropped some: the sum would read low) is taken
    again, up to ``tries`` windows; then the time is not measured (nan)."""
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
        rows = [r for r in _kernel_rows(prof)
                if names is None or any(n in r[1] for n in names)]
        launches = sum(r[2] for r in rows)
        if launches and launches % iters == 0:
            return sum(r[0] for r in rows) / 1e3 / iters
    return float("nan")


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
    """The decode attention kernel run with lane 0 one token short, one
    page short, and every lane cut back to the start of its last split
    computes what a kernel that skipped that token or page, or whose combine
    dropped each slot's last split, would; the comparison with the
    reference must reject all three."""
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import SPLIT

    live = lengths > 0
    lane0 = torch.zeros_like(lengths)
    lane0[0] = 1
    for fault, bad_len in (
            ("lane 0 one token short", lengths - lane0),
            ("lane 0 one page short", lengths - page * lane0),
            ("every lane's last split dropped",
             torch.clamp_min(lengths - 1, 0) // SPLIT * SPLIT)):
        bad = paged_decode_attention(q, kp, vp, block, bad_len)
        torch.cuda.synchronize()
        err, limit = _attn_errors(torch, bad[live], ref[live])
        caught = int((err > limit).sum())
        r = ref[live].float().abs()
        loose = int((err > 1e-2 + 1e-2 * r).sum())
        log(f"[kernels] planted fault, lens {lengths.tolist()}, "
            f"{fault}: max|err| {err.max().item():.3e}; {caught} of "
            f"{err.numel()} outputs above {ATTN_TOL}; {loose} above "
            f"1e-2 + 1e-2*|ref|")
        if caught == 0:
            raise AssertionError(f"planted fault ({fault}) passes the "
                                 f"decode attention check")


def _b1_batch_invariance(torch, q, kp, vp, block, lengths, got) -> None:
    """Lane 0 of the batch, alone and under a block table twice as wide:
    the same output bits (split boundaries at absolute key positions, sums
    in a fixed order)."""
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention

    q0, len0 = q[:1].contiguous(), lengths[:1].clone()
    alone = paged_decode_attention(q0, kp, vp, block[:1].contiguous(), len0)
    wide = torch.cat([block[:1], block[1:2]], dim=1).contiguous()
    wider = paged_decode_attention(q0, kp, vp, wide, len0)
    torch.cuda.synchronize()
    same = torch.equal(alone[0], got[0]) and torch.equal(wider[0], got[0])
    log(f"[kernels] paged_decode_attention lane 0 (len {int(len0[0])}) alone, "
        f"in the batch of {q.shape[0]} and under a block table of "
        f"{wide.shape[1]} pages: {'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("paged_decode_attention: a slot's bits depend on "
                             "the batch or the block table's width")


def _b2_last_stage_fault(torch, variant, stage, x, w, got, ref) -> None:
    """What a B2 kernel that skipped its last K stage (``stage`` bytes: a
    128-byte TMA stage of the tensor-core GEMM, a 64-byte slab of the GeMV)
    computes: the kernel's own output less that stage's exact products; the
    bit-exact check must reject it."""
    from repro_torch.kernels.int8_pagegemv.ref import int8_gemm_ref

    k = x.shape[1]
    k_last = (k - 1) // stage * stage
    bad = got - int8_gemm_ref(x[:, k_last:].contiguous(),
                              w[:, k_last:].contiguous())
    caught = int((bad != ref).sum())
    log(f"[kernels] planted fault, {variant} with its last K stage "
        f"(bytes {k_last}..{k - 1}) skipped: {caught} of {ref.numel()} "
        f"entries differ from the exact product")
    if caught == 0:
        raise AssertionError(f"planted fault (last K stage skipped) passes the "
                             f"{variant} check")


def _host_launch_us(torch, rand_i8, calls: int = 500) -> None:
    """Host time of one launch (perf_counter over ``calls`` launches at
    shapes the card finishes faster than the host issues them, read before
    the final synchronize): B2's tensor-core GEMM and B3, which encode two
    and three TMA tensor maps and set the kernel's shared-memory attribute
    on every launch, against the GeMV, which does neither, and B1, whose
    wrapper allocates a workspace and whose C entry launches two kernels.
    Through the wrappers (what a caller pays) and, for the B2 variants,
    through the C entry points (their difference is the maps and the
    attribute)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.int8_pagegemv.ops import int8_gemm

    lib = build.library()
    stream = build.stream_handle(torch.device("cuda"))
    w = rand_i8(256, 64)
    x_tc, x_gemv = rand_i8(16, 64), rand_i8(4, 64)
    out = torch.empty((16, 256), dtype=torch.int32, device="cuda")
    q, k, v = (torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16,
                           device="cuda") for _ in range(3))

    def c_tc():
        build.check(lib.repro_int8_gemm_tc(
            x_tc.data_ptr(), w.data_ptr(), out.data_ptr(), 16, 256, 64,
            stream), "int8_gemm_tc")

    def c_gemv():
        build.check(lib.repro_int8_gemv(
            x_gemv.data_ptr(), w.data_ptr(), out.data_ptr(), 4, 256, 64,
            stream), "int8_gemv")

    qd = torch.zeros((4, 32, 128), dtype=torch.bfloat16, device="cuda")
    pool = torch.zeros((65, 16, 32, 128), dtype=torch.bfloat16, device="cuda")
    block = torch.arange(1, 65, dtype=torch.int32, device="cuda").reshape(4, 16)
    lens = torch.full((4,), 200, dtype=torch.int32, device="cuda")

    runs = {"int8_gemm_tc wrapper": lambda: int8_gemm(x_tc, w),
            "int8_gemm_tc C entry": c_tc,
            "flash_attention wrapper": lambda: flash_attention(q, k, v),
            "int8_gemv wrapper": lambda: int8_gemm(x_gemv, w),
            "int8_gemv C entry": c_gemv,
            "paged_decode_attention wrapper": lambda: paged_decode_attention(
                qd, pool, pool, block, lens)}
    parts = []
    for tag, fn in runs.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e6
        parts.append(f"{tag} {host:.2f} us ({wall:.2f} with the sync)")
    log("[kernels] host time per launch, perf_counter over "
        f"{calls} launches: " + "; ".join(parts))


def _flash_faults(torch, q, k, v, ref) -> None:
    """What a B3 kernel with a planted fault computes, in float32 on the
    card and rounded to bf16 as the kernel's output is: its causal mask
    admitting key i+1, or its last K/V block (the diagonal block of 64 keys
    from key 0) dropped, a query with no key left giving 0 as the kernel's
    empty sum does.  The attention check must reject both."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (t.float().repeat_interleave(rep, dim=2).transpose(1, 2)
              for t in (k, v))
    sc = (qf @ kf.transpose(-1, -2)) * d ** -0.5
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    for fault, mask in (("causal mask admitting key i+1", j <= i + 1),
                        ("last K/V block dropped", j < i // 64 * 64)):
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        bad = (torch.nan_to_num(p, nan=0.0) @ vf).transpose(1, 2).to(q.dtype)
        err, limit = _attn_errors(torch, bad, ref)
        caught = int((err > limit).sum())
        log(f"[kernels] planted fault, flash_attention with its {fault} "
            f"(B={b} S={s} H={h} D={d}): {caught} of {err.numel()} outputs "
            f"above {ATTN_TOL}, max|err| {err.max().item():.3e}")
        if caught == 0:
            raise AssertionError(f"planted fault ({fault}) passes the "
                                 f"flash_attention check")


def phase_kernels(torch, results: dict) -> None:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        SPLIT, paged_decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.int8_pagegemv.ops import gemm_variant, int8_gemm
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
    # zamba2-7b: in_proj 3584->14576 (N not a multiple of the 128-wide
    # tile), out_proj 7168->3584, the shared block's down 14336->3584; M =
    # 4 slots at decode (the tensor-core GeMV), 4 x 512 at prefill, 9 and
    # 130 (ragged M tiles); smollm K=960 / 2560.  A K that is not a multiple
    # of 16 takes the __dp4a tiled variant above M = 8 and the __dp4a GeMV
    # below
    shapes = [(4, 4096, 4096), (4, 4096, 11008), (4, 11008, 4096),
              (4, 3584, 14576), (4, 7168, 3584), (4, 14336, 3584),
              (2048, 4096, 4096), (2048, 4096, 11008), (2048, 11008, 4096),
              (2048, 3584, 14576), (2048, 7168, 3584), (9, 4096, 11008),
              (130, 3584, 14576), (4, 960, 2560), (2048, 2560, 960),
              (1, 960, 320), (5, 1000, 300), (37, 1000, 130), (3, 64, 128),
              (2048, 4104, 11008), (4, 4104, 11008)]
    timed_b2 = {(4, 4096, 4096): "llama2-7b q/k/v/o",
                (4, 4096, 11008): "llama2-7b gate/up",
                (4, 11008, 4096): "llama2-7b down",
                (4, 3584, 14576): "zamba2-7b in_proj",
                (4, 7168, 3584): "zamba2-7b out_proj",
                (2048, 4096, 11008): "llama2-7b",
                (2048, 3584, 14576): "zamba2-7b in_proj",
                (2048, 4104, 11008): "off every model path, K % 16 == 8",
                (4, 4104, 11008): "off every model path, K % 16 == 8"}
    json_b2 = {"int8_gemv": (4, 4096, 11008),
               "int8_gemv_dp4a": (4, 4104, 11008),
               "int8_gemm_tc": (2048, 4096, 11008),
               "int8_gemm": (2048, 4104, 11008)}
    for m, k, n in shapes:
        x = rand_i8(m, k)
        # enough weight copies that a timed GeMV streams them from device
        # memory, not from the 50 MB L2
        n_w = (max(4, -(-120_000_000 // (n * k)))
               if m <= 8 and (m, k, n) in timed_b2 else 1)
        ws = [rand_i8(n, k) for _ in range(n_w)]
        variant = gemm_variant(m, k, x.data_ptr(), ws[0].data_ptr())
        got = int8_gemm(x, ws[0])
        ref = int8_gemm_ref(x, ws[0])
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = (got != ref).sum().item()
            raise AssertionError(f"{variant} M={m} K={k} N={n}: {bad} "
                                 f"entries differ from the exact product")
        results[variant]["max_abs_err"] = 0.0
        line = f"[kernels] {variant} M={m} K={k} N={n}: bit-exact"
        if (m, k, n) in timed_b2:
            ms = time_ms(torch, lambda i: int8_gemm(x, ws[i]), len(ws))
            dev_ms = profiled_ms(torch, lambda i: int8_gemm(x, ws[i]),
                                 (KERNEL_NAMES[variant],), len(ws))
            plain = time_ms(torch, lambda i: int8_gemm_ref(x, ws[i]), len(ws))
            lib = lib_dev = None
            if k % 8 == 0 and n % 8 == 0:
                # torch._int_mm takes M > 16 only: a GeMV's x goes in
                # zero-padded to 24 rows, padded outside the timed calls
                xl = x if m > 16 else torch.cat(
                    [x, x.new_zeros((24 - m, k))])
                wt = [w.t() for w in ws]
                lib = time_ms(torch, lambda i: torch._int_mm(xl, wt[i]),
                              len(ws))
                lib_dev = profiled_ms(
                    torch, lambda i: torch._int_mm(xl, wt[i]), None, len(ws))
            b_ms, b_by = bound(m * k + n * k + 4 * m * n, 2 * m * n * k,
                               "int8")
            if (m, k, n) == json_b2.get(variant):
                results[variant].update(
                    ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                    library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
                    shape=f"M={m} K={k} N={n}")
            pad = " (x padded to 24 rows)" if m <= 16 else ""
            lib_s = ("n/a" if lib is None
                     else f"{lib:.4f} ms (device {lib_dev:.4f} ms){pad}")
            line += (f" | {timed_b2[(m, k, n)]}: {ms:.4f} ms (device time "
                     f"{dev_ms:.4f} ms, {2 * m * n * k / dev_ms / 1e9:.0f} "
                     f"TOP/s, {(n * k + m * k) / dev_ms / 1e6:.0f} GB/s, "
                     f"{100 * b_ms / dev_ms:.1f}% of the bound), plain "
                     f"{plain:.4f} ms, library {lib_s}, bound {b_ms:.4f} ms "
                     f"({b_by})")
        log(line)
        if (m, k, n) == (2048, 4096, 11008):
            _b2_last_stage_fault(torch, variant, 128, x, ws[0], got, ref)
        if (m, k, n) == (4, 4096, 11008):
            _b2_last_stage_fault(torch, variant, 64, x, ws[0], got, ref)
    # the GeMV at every decode batch size
    w = rand_i8(11008, 4096)
    for m in range(1, 9):
        x = rand_i8(m, 4096)
        if not torch.equal(int8_gemm(x, w), int8_gemm_ref(x, w)):
            raise AssertionError(f"int8_gemv M={m} K=4096 N=11008: not the "
                                 f"exact product")
    log("[kernels] int8_gemv M=1..8 K=4096 N=11008: bit-exact")
    # a base off the 16-byte grid sends a model shape to the __dp4a kernels
    for m in (130, 4):
        buf = rand_i8(m * 4096 + 1)
        x, w = buf[1:].view(m, 4096), rand_i8(4096, 4096)
        variant = gemm_variant(m, 4096, x.data_ptr(), w.data_ptr())
        if variant != ("int8_gemm" if m > 8 else "int8_gemv_dp4a") \
                or not torch.equal(int8_gemm(x, w), int8_gemm_ref(x, w)):
            raise AssertionError(f"{variant} M={m} K=4096 N=4096, x base "
                                 f"misaligned: not the exact product")
        log(f"[kernels] {variant} M={m} K=4096 N=4096, x base 1 byte off the "
            f"16-byte grid: bit-exact")
    _host_launch_us(torch, rand_i8)

    # ---- B1: paged decode attention ---------------------------------------
    # lens: the PR 11-14 timed batch (its llama2-7b row is the JSON row);
    # the split edges (SPLIT = 64 keys); the serve trace's own lengths,
    # its first and second admitted groups 16 tokens into their decode
    page = 16
    timed = ("llama2-7b", "zamba2-7b", "serve group 1", "serve group 2",
             "serve group 2, D 112")
    faulted = ("llama2-7b", "zamba2-7b")
    edges = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 1024]
    for tag, b, h, hkv, d, max_seq, lens in [
            ("llama2-7b", 4, 32, 32, 128, 1024, [1024, 545, 17, 0]),
            ("zamba2-7b", 4, 32, 32, 112, 1024, [1024, 545, 17, 0]),
            ("smollm-360m", 4, 15, 5, 64, 1024, [700, 64, 1, 0]),
            ("split edges", 6, 32, 32, 128, 1024, edges),
            ("split edges, D 112", 6, 32, 32, 112, 1024, edges),
            ("serve group 1", 4, 32, 32, 128, 1024, [252, 127, 197, 272]),
            ("serve group 2", 4, 32, 32, 128, 1024, [403, 331, 275, 439]),
            ("serve group 2, D 112", 4, 32, 32, 112, 1024,
             [403, 331, 275, 439])]:
        pps = max_seq // page
        n_pages = b * pps + 1
        n_bufs = 3 if tag in timed else 1
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
        if not bool(torch.isfinite(got.float()).all()) \
                or bool(got[~live].float().any()):
            raise AssertionError("a length-0 lane is not 0")
        res = results["paged_decode_attention"]
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
        line = (f"[kernels] paged_decode_attention {tag} B={b} H={h} "
                f"Hkv={hkv} D={d} lens={lens}: max|err| {err:.3e} "
                f"(worst |err|/limit {used:.3f}; tol {ATTN_TOL}), length-0 "
                f"lane 0")
        if tag in faulted:
            _planted_faults(torch, q, kp, vp, block, lengths, ref, page)
            _b1_batch_invariance(torch, q, kp, vp, block, lengths, got)
        if tag in timed:
            ms = time_ms(torch, lambda i: paged_decode_attention(
                q, pools[i][0], pools[i][1], block, lengths), n_bufs)
            dev_ms = profiled_ms(torch, lambda i: paged_decode_attention(
                q, pools[i][0], pools[i][1], block, lengths),
                (KERNEL_NAMES["paged_decode_attention"],), n_bufs)
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
            lib_dev = profiled_ms(
                torch, lambda i: F.scaled_dot_product_attention(
                    q4, kd[i], vd[i], attn_mask=mask), None, n_bufs)
            n_tok = sum(lens)
            kv_bytes = n_tok * hkv * d * 2 * 2
            bytes_moved = (2 * b * h * d * 2 + kv_bytes + block.numel() * 4
                           + b * 4)
            b_ms, b_by = bound(bytes_moved, 4 * n_tok * h * d, "bf16")
            if tag == "llama2-7b":
                res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                           library_ms=lib, library_device_ms=lib_dev,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"B={b} H={h} D={d} lens={lens}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms, K/V "
                     f"{kv_bytes / dev_ms / 1e6:.0f} GB/s, "
                     f"{dev_ms * 1e6 / kv_bytes:.4f} ns per K/V byte), plain "
                     f"{plain:.4f} ms, SDPA on the gathered cache {lib:.4f} "
                     f"ms (device {lib_dev:.4f} ms), bound {b_ms:.4f} ms "
                     f"({b_by})")
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
            lib_dev = profiled_ms(
                torch, lambda i: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
            bytes_moved = (2 * b * s * h * d + 2 * b * s * hkv * d) * 2
            ops = 4 * b * h * d * s * (s + 1) / 2
            b_ms, b_by = bound(bytes_moved, ops, "bf16")
            if tag == "llama2-7b":
                res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                           library_ms=lib, library_device_ms=lib_dev,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"B={b} S={s} H={h} D={d}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms), plain "
                     f"{plain:.4f} ms, SDPA {lib:.4f} ms (device {lib_dev:.4f} "
                     f"ms), bound {b_ms:.4f} ms ({b_by})")
        log(line)
        if tag in timed:
            _flash_faults(torch, q, k, v, ref)

    _kernels_ecc(torch, results)
    _kernels_w4a16(torch, results)
    _kernels_ssd(torch, results)


def _planted_collisions(torch, ecc, pages):
    """Sidecars of 4 clean ``pages`` with colliding entries; the n-th entry
    placed on a page's address gets value copies 0x11 (n + 1).  Returns
    (sidecars, each page's address, the byte the last entry leaves there).
    Page 0: entry 0 valid, then entry K-1 invalid, on a value below the
    threshold (it stays); page 1: entry 0 invalid, then K-1 valid (0x22);
    page 2: entries 0, K/2 and K-1 valid on one address (0x33); page 3:
    entry 0 valid, then K-1 invalid, on an outlier above the threshold
    (clamped to 0).  Inverting an entry's 5 parity bits puts its syndrome
    at 31: invalid."""
    code = ecc.encode_pages(pages)
    addr, parity, copies = (code.addr.clone(), code.addr_parity.clone(),
                            code.copies.clone())
    k = addr.shape[1]
    mag = pages.view(torch.int8).to(torch.int32).abs()
    thr = code.threshold[:, 0].to(torch.int32)
    low = int(torch.nonzero(mag[0] <= thr[0])[0, 0])
    plan = [(low, {0: True, k - 1: False}),
            (int(addr[1, 0]), {0: False, k - 1: True}),
            (int(addr[2, 0]), {0: True, k // 2: True, k - 1: True}),
            (int(addr[3, 0]), {0: True, k - 1: False})]
    if int(mag[3, plan[3][0]]) <= int(thr[3]):
        raise AssertionError("planted collisions: page 3's outlier is not "
                             "above the threshold")
    for page, (target, entries) in enumerate(plan):
        for n, (e, valid) in enumerate(entries.items()):
            addr[page, e] = target
            parity[page, e] = int(ecc.hamming_encode(addr[page, e:e + 1])[0]) \
                ^ (0 if valid else 0x1F)
            copies[page, e] = 0x11 * (n + 1)
    want = [int(pages[0, low]), 0x22, 0x33, 0]
    return (ecc.PageECC(code.threshold, addr.contiguous(),
                        parity.contiguous(), copies.contiguous()),
            [t for t, _ in plan], want)


def _kernels_ecc(torch, results: dict) -> None:
    """B5 against its plain version on 4,096 random int8 pages at three
    BERs, on one page, and on pages with planted colliding entries, every
    position; the planted fault (the last sidecar entry's restore skipped)
    must fail."""
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
            # what the card takes to read and write the same pages
            outs = [torch.empty_like(t) for t in bufs]
            copy_ms = profiled_ms(torch, lambda i: outs[i].copy_(bufs[i]),
                                  None, 2)
            res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                       library_ms=None, bound_ms=b_ms,
                       bound_by=b_by, shape=f"B={n} P={ecc.PAGE_ELEMS} K={k}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms, "
                     f"{100 * b_ms / dev_ms:.1f}% of the bound), plain "
                     f"{plain:.4f} ms, library n/a (no PyTorch call decodes "
                     f"the sidecar), bound {b_ms:.4f} ms ({b_by}); the "
                     f"pages copied by PyTorch, device {copy_ms:.4f} ms")
        log(line)
    one = torch.randint(0, 256, (1, ecc.PAGE_ELEMS), generator=gen,
                        device=dev, dtype=torch.uint8)
    code = ecc.inject_ecc_bitflips(ecc.encode_pages(one), 2e-3, gen)
    one = ecc.inject_bitflips(one, 2e-3, gen)
    if not torch.equal(ecc_decode(one, code), ecc.decode_pages(one, code)):
        raise AssertionError("ecc_decode on one page differs from the plain "
                             "decode")
    log("[kernels] ecc_decode 1 page BER 0.002: bit-exact on every position")
    pages = torch.randint(0, 256, (4, ecc.PAGE_ELEMS), generator=gen,
                          device=dev, dtype=torch.uint8)
    code, at, want = _planted_collisions(torch, ecc, pages)
    got = ecc_decode(pages, code)
    ref = ecc.decode_pages(pages, code)
    seen = [int(ref[p, a]) for p, a in enumerate(at)]
    if not torch.equal(got, ref) or seen != want:
        raise AssertionError(f"ecc_decode on planted collisions: "
                             f"{int((got != ref).sum())} bytes differ from "
                             f"the plain decode; bytes at the collisions "
                             f"{seen}, the rule gives {want}")
    log(f"[kernels] ecc_decode planted collisions (valid then invalid, "
        f"invalid then valid, three on one address, an outlier left to an "
        f"invalid last entry): bit-exact, bytes at the collisions {seen}")


# B4's shapes (M, K, N): zamba2-7b's shared block (q/k/v/o 3584 -> 3584,
# gate/up 3584 -> 14336, down 14336 -> 3584) and lm_head (3584 -> 32000) at
# decode (M = 4 slots, the GeMV) and at prefill (M = 2048, the tiled GEMM);
# llama2-7b's lm_head and MLP, smollm's width (7.5 groups), M = 1, 9, 20 and
# 130 (ragged M tiles), a ragged K (g = 100, byte-wise loads) and N; each in
# bf16 and in float32 x.  Timed (bf16 x; float32 too at llama2-7b's lm_head)
# where a tag is given; the JSON rows are llama2-7b's lm_head at decode and
# zamba2-7b's gate/up at prefill
W4_SHAPES = {(4, 3584, 3584): "zamba2-7b q/k/v/o",
             (4, 3584, 14336): "zamba2-7b gate/up",
             (4, 14336, 3584): "zamba2-7b down",
             (4, 3584, 32000): "zamba2-7b lm_head",
             (4, 4096, 32000): "llama2-7b lm_head",
             (2048, 3584, 3584): "zamba2-7b q/k/v/o",
             (2048, 3584, 14336): "zamba2-7b gate/up",
             (2048, 14336, 3584): "zamba2-7b down",
             (4, 4096, 11008): None, (4, 960, 2560): None,
             (1, 4096, 4096): None, (9, 4096, 4096): None,
             (20, 4096, 4096): None, (130, 3584, 14336): None,
             (3, 100, 70): None, (37, 1000, 130): None}
W4_JSON = {"w4a16_gemv": (4, 4096, 32000), "w4a16_gemm": (2048, 3584, 14336)}
# (K, N) of the batch-invariance check: zamba2-7b's gate/up, llama2-7b's head
W4_INVARIANCE = ((3584, 14336), (4096, 32000))
# the library yardstick's packing: torch._convert_weight_to_int4pack takes
# [N, K/2] bytes with the even column in the high nibble (the port packs it
# in the low one), and qScaleAndZeros [K/g, N, 2] in bf16, zero 0 here
def _w4_operands(torch, gen, n, k, copies):
    """``copies`` W4A16 weights [N, K]: the first quantized from a random
    normal matrix, the rest random bytes under the same scales (timing
    copies, so that a weight-streaming product does not find them in the
    50 MB L2)."""
    from repro_torch.quant.int4 import quantize_weight4

    dev = torch.device("cuda")
    q = quantize_weight4(torch.randn((n, k), generator=gen, device=dev)
                         * k ** -0.5)
    out = [(q.w_packed.contiguous(), q.scale)]
    for _ in range(copies - 1):
        out.append((torch.randint(0, 256, (n, k // 2), generator=gen,
                                  device=dev, dtype=torch.uint8), q.scale))
    return out


def _int4pack_library(torch, x, wps, ref, limit):
    """torch._weight_int4pack_mm on bf16 x and the same nibbles (its own
    packing, qScaleAndZeros with zero 0, the scales rounded to bf16):
    (callable over the weight copies, its worst |err| / W4_TOL on copy 0),
    or (None, the reason) where the card's torch refuses it or its product
    is not the plain version's within two bf16 steps of |x| @ |W|^T."""
    k = x.shape[1]
    g = min(128, k)
    xb = x.to(torch.bfloat16)
    try:
        packed = [torch._convert_weight_to_int4pack(
            (((wp & 0xF) << 4) | (wp >> 4)).contiguous(), 8) for wp, _ in wps]
        sz = [torch.stack([sc.T, torch.zeros_like(sc.T)], -1)
              .to(torch.bfloat16).contiguous() for _, sc in wps]
        y = torch._weight_int4pack_mm(xb, packed[0], g, sz[0]).float()
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError, TypeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    used = ((y - ref).abs() / limit).max().item()
    if used * W4_REL >= 2.0 ** -7:
        return None, f"its product is off: worst |err| / W4_TOL {used:.3g}"
    return (lambda i: torch._weight_int4pack_mm(xb, packed[i], g, sz[i])), used


def _w4_faults(torch, variant, x, wp, sc, ref, check) -> None:
    """What a B4 kernel with a planted fault computes, each through the
    kernel itself on altered inputs: lo/hi nibbles swapped (the swapped
    bytes), every group's partial scaled by the next group's scale (the
    scales rolled by one group), and, for the tiled variant, its last K tile
    of 64 columns skipped (x zero there).  The W4_TOL check must reject
    each."""
    from repro_torch.kernels.w4a16_gemv.ops import w4a16_gemm

    k = x.shape[1]
    faults = {"lo/hi nibbles swapped": (x, ((wp >> 4) | (wp << 4))
                                        .contiguous(), sc),
              "each group's partial scaled by the next group's scale":
                  (x, wp, torch.roll(sc, -1, 1).contiguous())}
    if variant == "w4a16_gemm":
        cut = x.clone()
        cut[:, (k - 1) // 64 * 64:] = 0
        faults[f"its last K tile (columns {(k - 1) // 64 * 64}..{k - 1}) "
               f"skipped"] = (cut, wp, sc)
    for fault, (xf, wf, sf) in faults.items():
        bad, err, _ = check(w4a16_gemm(xf, wf, sf), ref, x, wp, sc)
        log(f"[kernels] planted fault, {variant} M={x.shape[0]} K={k} "
            f"N={wp.shape[0]} with {fault}: {bad} of {ref.numel()} outputs "
            f"above the tolerance, max|err| {err:.3e}")
        if bad == 0:
            raise AssertionError(f"planted fault ({fault}) passes the "
                                 f"{variant} check")


def _w4_invariance(torch, gen, check) -> None:
    """A row's bits at M = 1..8 (the GeMV) against the same rows of M = 8,
    in bf16 and float32 x, at zamba2-7b's gate/up and llama2-7b's lm_head;
    then the GeMV's M = 8 rows against the tiled variant's at M = 9 (stated,
    not gated)."""
    from repro_torch.kernels.w4a16_gemv.ops import w4a16_gemm
    from repro_torch.kernels.w4a16_gemv.ref import w4a16_gemm_ref

    for k, n in W4_INVARIANCE:
        (wp, sc), = _w4_operands(torch, gen, n, k, 1)
        for dt in (torch.bfloat16, torch.float32):
            x9 = torch.randn((9, k), generator=gen, device="cuda").to(dt)
            full = w4a16_gemm(x9[:8].contiguous(), wp, sc)
            same = all(torch.equal(w4a16_gemm(x9[:m].contiguous(), wp, sc),
                                   full[:m]) for m in range(1, 8))
            tiled = w4a16_gemm(x9, wp, sc)[:8]
            torch.cuda.synchronize()
            ref = w4a16_gemm_ref(x9[:8], wp, sc)
            if check(tiled, ref, x9[:8], wp, sc)[0]:
                raise AssertionError("w4a16_gemm at M = 9 outside W4_TOL")
            diff = tiled != full
            name = str(dt).split(".")[-1]
            log(f"[kernels] w4a16_gemv K={k} N={n} {name} x: rows at M = "
                f"1..7 against the same rows at M = 8: "
                f"{'bit-identical' if same else 'DIFFERENT'}; the tiled "
                f"variant at M = 9 gives other bits in {int(diff.sum())} of "
                f"{diff.numel()} outputs (max |diff| "
                f"{(tiled - full).abs().max().item():.3e}), both within "
                f"{W4_TOL}")
            if not same:
                raise AssertionError("w4a16_gemv: a row's bits depend on M")


def _kernels_w4a16(torch, results: dict) -> None:
    """B4 against its plain version at W4_SHAPES in bf16 and float32 x,
    within W4_TOL; planted faults (swapped nibbles, the next group's scale,
    the tiled variant's last K tile skipped) must fail; a row's bits must
    not depend on M within 1..8.  Timed beside its bound on the bf16 tensor
    cores and torch._weight_int4pack_mm."""
    from repro_torch.kernels.w4a16_gemv.ops import variant, w4a16_gemm
    from repro_torch.kernels.w4a16_gemv.ref import w4a16_gemm_ref
    from repro_torch.quant.int4 import QuantizedLinear4, dequantize4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    for name in W4_JSON:
        results[name]["max_abs_err"] = 0.0

    def check(got, ref, x, wp, sc):
        w = dequantize4(QuantizedLinear4(wp, sc, wp.shape[0], x.shape[1]))
        limit = W4_REL * (x.float().abs() @ w.abs().T) + W4_ABS
        err = (got - ref).abs()
        torch.cuda.synchronize()
        return int((err > limit).sum()), err.max().item(), \
            (err / limit).max().item()

    for (m, k, n), tag in W4_SHAPES.items():
        var = variant(m)
        copies = max(4, -(-120_000_000 // (n * k // 2))) \
            if tag and m <= 8 else 1
        wps = _w4_operands(torch, gen, n, k, copies)
        wp, sc = wps[0]
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device=dev).to(dt)
            got = w4a16_gemm(x, wp, sc)
            ref = w4a16_gemm_ref(x, wp, sc)
            bad, err, used = check(got, ref, x, wp, sc)
            dname = str(dt).split(".")[-1]
            if bad:
                raise AssertionError(f"{var} M={m} K={k} N={n} {dname} x: "
                                     f"{bad} outputs above {W4_TOL}")
            results[var]["max_abs_err"] = max(results[var]["max_abs_err"],
                                              err)
            line = (f"[kernels] {var} M={m} K={k} N={n} {dname} x: max|err| "
                    f"{err:.3e} (worst |err|/limit {used:.3f}; tol {W4_TOL})")
            if dt == torch.bfloat16 and (m, k, n) in W4_JSON.values():
                _w4_faults(torch, var, x, wp, sc, ref, check)
            timed = tag is not None and (
                dt == torch.bfloat16 or (m, k, n) == W4_JSON["w4a16_gemv"])
            if timed:
                kname = KERNEL_NAMES[var]
                ms = time_ms(torch, lambda i: w4a16_gemm(x, *wps[i]), copies)
                dev_ms = profiled_ms(torch, lambda i: w4a16_gemm(x, *wps[i]),
                                     (kname,), copies)
                plain = time_ms(torch, lambda i: w4a16_gemm_ref(x, *wps[i]),
                                copies, iters=10)
                w = dequantize4(QuantizedLinear4(wp, sc, n, k))
                limit = W4_REL * (x.float().abs() @ w.abs().T) + W4_ABS
                del w
                lib_fn, lib_used = _int4pack_library(torch, x, wps, ref,
                                                     limit)
                lib = lib_dev = None
                if lib_fn is not None:
                    lib = time_ms(torch, lib_fn, copies)
                    lib_dev = profiled_ms(torch, lib_fn, None, copies)
                    lib_s = (f"{lib:.4f} ms (device {lib_dev:.4f} ms; "
                             f"torch._weight_int4pack_mm on bf16 x, bf16 "
                             f"scales and output: worst |err|/W4_TOL "
                             f"{lib_used:.3g})")
                else:
                    lib_s = f"none (torch._weight_int4pack_mm: {lib_used})"
                xb = 2 if dt == torch.bfloat16 else 4
                terms = 1 if dt == torch.bfloat16 else 3
                ng = sc.shape[1]
                bytes_moved = n * k // 2 + n * ng * 4 + m * k * xb + m * n * 4
                ops = 2 * m * n * k * terms
                b_ms, b_by = bound(bytes_moved, ops, "bf16")
                if dt == torch.bfloat16 and (m, k, n) == W4_JSON[var]:
                    results[var].update(
                        ms=ms, device_ms=dev_ms, plain_ms=plain,
                        library_ms=lib, library_device_ms=lib_dev,
                        bound_ms=b_ms, bound_by=b_by,
                        shape=f"M={m} K={k} N={n} bf16 x")
                line += (f" | {tag}: {ms:.4f} ms (device time {dev_ms:.4f} "
                         f"ms, {100 * b_ms / dev_ms:.1f}% of the bound, "
                         f"{ops / dev_ms / 1e9:.0f} TFLOP/s, "
                         f"{bytes_moved / dev_ms / 1e6:.0f} GB/s), plain "
                         f"{plain:.4f} ms, library {lib_s}, bound "
                         f"{b_ms:.4f} ms ({b_by}: {bytes_moved / 1e6:.1f} MB "
                         f"at 3.35 TB/s; {ops / 1e9:.1f} GFLOP at the bf16 "
                         f"tensor-core peak)")
            log(line)
        del wps
    _w4_invariance(torch, gen, check)


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
    (Q 8), two B/C groups, Q 64 with 22 heads (a ragged last head block)
    and Q 40 with N 24 (zero-filled tiles), within SSD_TOL; two planted mask
    faults and, at G 2, every head reading group 0's C B^T must fail.
    Timed at the zamba2-7b and mamba2-130m shapes."""
    from repro_torch.kernels.ssd_scan.ops import (ctas_per_sm, head_block,
                                                  ssd_intra_chunk)
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_model_ref

    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = results["ssd_intra_chunk"]
    res["max_abs_err"] = 0.0
    tol = f"rtol = atol = {SSD_TOL} against the float64 plain version"
    timed = ("zamba2-7b", "mamba2-130m")

    def gate(got, ref):
        """Outputs beyond the tolerance, and the worst |err| / limit."""
        e = (got.double() - ref).abs()
        limit = SSD_TOL + SSD_TOL * ref.abs()
        return int((~(e <= limit)).sum()), e, (e / limit).max().item()

    for tag, b, s, h, g, p, n, chunk in [
            ("zamba2-7b", 4, 512, 112, 1, 64, 64, 128),
            ("mamba2-130m", 4, 512, 24, 1, 64, 128, 128),
            ("Q 8", 4, 8, 8, 1, 16, 16, 8),
            ("G 2", 2, 256, 16, 2, 32, 64, 64),
            ("Q 64, 22 heads", 4, 1024, 22, 1, 64, 64, 64),
            ("Q 40, N 24", 1, 80, 8, 1, 32, 24, 40)]:
        n_bufs = 2 if tag in timed else 1
        ins = [_ssd_inputs(torch, gen, b, s, h, g, p, n)
               for _ in range(n_bufs)]
        x, a, bm, cm = ins[0]
        got = ssd_intra_chunk(x, a, bm, cm, chunk)
        ref = ssd_intra_chunk_model_ref(x, a, bm, cm, chunk, torch.float64)
        ref32 = ssd_intra_chunk_model_ref(x, a, bm, cm, chunk)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"ssd_intra_chunk[{tag}]: non-finite output")
        bad, err, used = gate(got, ref)
        if bad:
            raise AssertionError(
                f"ssd_intra_chunk[{tag}]: {bad} outputs beyond {tol}, max "
                f"|err| {err.max().item():.3e}")
        _, err32, used32 = gate(ref32, ref)
        res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
        hpc = head_block(b, s // chunk, h, g, sms * ctas_per_sm(p))
        line = (f"[kernels] ssd_intra_chunk {tag} B={b} S={s} H={h} G={g} "
                f"P={p} N={n} Q={chunk} ({hpc} heads a CTA): max|err| "
                f"{err.max().item():.3e} (worst |err|/limit {used:.3f}; tol "
                f"{tol}); the float32 plain version's own max|err| "
                f"{err32.max().item():.3e} (|err|/limit {used32:.3f}), "
                f"kernel vs it {(got - ref32).abs().max().item():.3e}")
        if tag == "zamba2-7b":
            for fault, wrong in _ssd_mask_faults(torch, x, a, bm, cm, chunk,
                                                 got).items():
                caught = gate(wrong, ref)[0]
                log(f"[kernels] planted fault, ssd_intra_chunk with the mask "
                    f"{fault}: {caught} of {ref.numel()} outputs beyond the "
                    f"tolerance")
                if caught == 0:
                    raise AssertionError(f"planted fault ({fault}) passes the "
                                         f"ssd_intra_chunk check")
        if tag == "G 2":
            # what a kernel that gives every CTA group 0's C B^T computes
            g0 = [m[:, :, :1].expand(-1, -1, g, -1).contiguous()
                  for m in (bm, cm)]
            caught = gate(ssd_intra_chunk(x, a, *g0, chunk), ref)[0]
            log(f"[kernels] planted fault, ssd_intra_chunk with every head "
                f"reading group 0's C B^T: {caught} of {ref.numel()} outputs "
                f"beyond the tolerance")
            if caught == 0:
                raise AssertionError("planted fault (group 0's C B^T) passes "
                                     "the ssd_intra_chunk check")
        if tag in timed:
            ms = time_ms(torch, lambda i: ssd_intra_chunk(*ins[i], chunk),
                         n_bufs)
            dev_ms = profiled_ms(torch, lambda i: ssd_intra_chunk(
                *ins[i], chunk), ("ssd_intra_chunk",), n_bufs)
            plain = time_ms(torch, lambda i: ssd_intra_chunk_model_ref(
                *ins[i], chunk), n_bufs, iters=10)
            # the function's least work: each input read once, y written
            # once; C B^T once per (batch, group, chunk) and S x per head,
            # over the causal half (Q(Q+1)/2 pairs), on the bf16 tensor
            # cores (x, B and C are bf16; S in bf16 terms)
            bytes_moved = (b * s * h * p * 2 + b * s * h * 4
                           + 2 * b * s * g * n * 2 + b * s * h * p * 4)
            ops = (2 * b * (s // chunk) * chunk * (chunk + 1) // 2
                   * (g * n + h * p))
            b_ms, b_by = bound(bytes_moved, ops, "bf16")
            # what the card takes to move the bulk of the same bytes: x read
            # as bf16 and written as float32 by one PyTorch copy
            ys = [torch.empty(t[0].shape, dtype=torch.float32,
                              device=t[0].device) for t in ins]
            copy_ms = profiled_ms(torch, lambda i: ys[i].copy_(ins[i][0]),
                                  None, n_bufs)
            if tag == "zamba2-7b":
                res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                           library_ms=None, bound_ms=b_ms, bound_by=b_by,
                           shape=f"B={b} S={s} H={h} G={g} P={p} N={n} "
                                 f"Q={chunk}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms, "
                     f"{100 * b_ms / dev_ms:.1f}% of the bound), plain "
                     f"{plain:.4f} ms, library n/a (no PyTorch call computes "
                     f"the decay-masked product), bound {b_ms:.4f} ms "
                     f"({b_by}: {bytes_moved / 1e6:.1f} MB at 3.35 TB/s; "
                     f"{ops / 1e9:.2f} GFLOP at the bf16 tensor-core peak "
                     f"{ops / PEAK_OPS['bf16'] * 1e3:.4f} ms, at the float32 "
                     f"CUDA-core peak {ops / PEAK_OPS['f32'] * 1e3:.4f} ms); "
                     f"x copied to float32 by PyTorch, device {copy_ms:.4f} "
                     f"ms")
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


def _serve_full(torch, arch: str, tag: str, smi: str, quant: str = "w8a8",
                n_req: int = 8, max_new: int = 32,
                required: tuple = ()) -> tuple[dict, object]:
    """``arch`` at full width, ``quant``, through launch/serve.py's
    build_client: 4 slots, max_seq 1024, page 16, ``n_req`` greedy requests
    with 64-512-token prompts and ``max_new`` new tokens each.  Every launch
    counter is zeroed before the run and read after; the kernels the phase
    owns (COUNTED_IN), SERVING_KERNELS and ``required`` must have launched.
    Returns the counts and the client."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch.serve import build_client
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg, client = build_client(arch, reduced=False, quant=quant,
                               max_batch=4, max_seq=1024, seed=0,
                               device="cuda")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    log(f"[{tag}] {arch} full width {quant.upper()} built in "
        f"{time.monotonic() - t0:.1f} s, {resident:.2f} GiB allocated "
        f"(weights and cache), build peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    core = client.router.cores[0]
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in rng.randint(64, 513, size=n_req)]

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

    handles = [client.submit(p, max_new_tokens=max_new) for p in prompts]
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
        if not h.finished or h.finish_reason != "length" \
                or len(toks) != max_new:
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
    log(f"[{tag}] {n_req} requests x {max_new} tokens: "
        f"tokens_out={stats.tokens_out} "
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
               if phase == tag and counts[k] <= 0 and k not in OFF_PATH]
    missing += [k for k in SERVING_KERNELS + tuple(required)
                if counts[k] <= 0 and k not in missing]
    if missing:
        raise AssertionError(f"the serving path never launched {missing}")
    _no_off_path(counts, tag)
    return counts, client


def _no_off_path(counts: dict, tag: str) -> None:
    stray = {k: counts[k] for k in OFF_PATH if counts[k] > 0}
    if stray:
        raise AssertionError(f"{tag}: the model path launched the off-path "
                             f"kernels {stray}")


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


def phase_serve_hybrid_w4a16(torch, smi: str) -> dict:
    """zamba2-7b at full width with --quant w4a16 (the shared block's seven
    linears and the lm_head W4A16, the Mamba layers W8A8, as the JAX convert
    makes them): 4 requests of 16 tokens, then where a prefill group's and
    a decode step's time goes, B4 by variant."""
    import gc

    counts, client = _serve_full(torch, "zamba2-7b", "serve_hybrid_w4a16",
                                 smi, quant="w4a16", n_req=4, max_new=16,
                                 required=("ssd_intra_chunk",))
    core = client.router.cores[0]
    if set(core.params["shared"]["ffn"]["up"]) != {"w_p4", "scale4"} \
            or set(core.params["lm_head"]) != {"w_p4", "scale4"}:
        raise AssertionError("zamba2-7b W4A16: the shared block or the "
                             "lm_head is not W4A16")
    phase_profile(torch, client, smi, "serve_hybrid_w4a16")
    del client, core
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# kernels whose device time the prefill and decode profiles report on their
# own (a part with no launch in the window is left out)
PREFILL_PARTS = (("B2 GEMM", ("int8_gemm_tc",)), ("B3", ("flash_attention",)),
                 ("B6", ("ssd_intra_chunk",)), ("B2 GeMV", ("int8_gemv",)),
                 ("B4 GEMM", ("w4a16_gemm_",)),
                 ("B4 GeMV", ("w4a16_gemv_",)))
DECODE_PARTS = (("B1", ("paged_decode_attention",)),
                ("B2 GeMV", ("int8_gemv",)), ("B4 GeMV", ("w4a16_gemv_",)))


def _by_part(rows, parts, per: float = 1.0) -> str:
    """'label ms (launches), ..., rest ms (launches)' of profiler rows,
    divided by ``per``."""
    out, named = [], set()
    for label, names in parts:
        sel = [r for r in rows if any(n in r[1] for n in names)]
        if not sel:
            continue
        named.update(r[1] for r in sel)
        out.append(f"{label} {sum(r[0] for r in sel) / 1e3 / per:.3f} ms "
                   f"({sum(r[2] for r in sel) / per:.0f} launches)")
    rest = [r for r in rows if r[1] not in named]
    out.append(f"rest {sum(r[0] for r in rest) / 1e3 / per:.3f} ms "
               f"({sum(r[2] for r in rest) / per:.0f} launches)")
    return ", ".join(out)


def _kernel_rows(prof) -> list[tuple[float, str, int]]:
    """(device us, name, calls) of each device kernel in a profiler run,
    largest first; a CPU op's "self device time" would repeat them."""
    rows = []
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            rows.append((dev_us, ev.key, ev.count))
    return sorted(rows, reverse=True)


def _prefill_profile(torch, client, smi: str, tag: str) -> None:
    """Where an admitted group's prefill time goes: 4 prompts of 400-512
    tokens (bucket 512) into the idle engine, torch.profiler over their
    admission (prefill_into_slots and the first tokens), device time by
    kernel."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    core = client.router.cores[0]
    rng = np.random.RandomState(2)
    for n in rng.randint(400, 513, size=4):
        client.submit([int(t) for t in rng.randint(0, 32000, n)],
                      max_new_tokens=2)
    torch.cuda.synchronize()
    prefills = core.stats.prefills
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        core._admit_continuous()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    if core.stats.prefills != prefills + 1:
        raise AssertionError("the profiled admission ran no single prefill")
    client.run()
    rows = _kernel_rows(prof)
    total = sum(r[0] for r in rows) / 1e3
    named = {r[1] for r in rows
             if any(n in r[1] for _l, names in PREFILL_PARTS for n in names)}
    rest = [r for r in rows if r[1] not in named]
    log(f"[{tag}] prefill profile, one group of 4 prompts (bucket 512): wall "
        f"{wall * 1e3:.1f} ms (profiled), {sum(r[2] for r in rows)} kernel "
        f"launches, device kernels {total:.2f} ms: "
        f"{_by_part(rows, PREFILL_PARTS)} on {smi}")
    if total <= 0:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    for dev_us, key, count in rest[:6]:
        log(f"[{tag}]   rest: {dev_us / 1e3:8.3f} ms  {count:5d} calls  "
            f"{key[:90]}")


def phase_profile(torch, client, smi: str, tag: str = "profile") -> None:
    """Where the time of a serve phase's engine (after its run) goes: one
    prefill group (``_prefill_profile``), then torch.profiler over 6 decode
    steps of 4 slots, device kernel time against the host's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    _prefill_profile(torch, client, smi, tag)
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
    rows = _kernel_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    launches = sum(r[2] for r in rows) / steps
    log(f"[{tag}] profile of {steps} decode steps of 4 slots: wall "
        f"{wall * 1e3 / steps:.2f} ms/step (profiled), {launches:.0f} kernel "
        f"launches/step, device kernels {busy * 1e3 / steps:.2f} ms/step, "
        f"device busy {100 * busy / wall:.1f}% of wall on {smi}")
    log(f"[{tag}] decode step by kernel (mean of {steps} steps): "
        f"{_by_part(rows, DECODE_PARTS, steps)} on {smi}")
    if busy <= 0:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    for dev_us, key, count in rows[:8]:
        log(f"[{tag}]   {dev_us / 1e3 / steps:8.3f} ms/step  "
            f"{count // steps:5d} calls/step  {key[:90]}")


def _device_ms(prof, names=None) -> float | None:
    """Summed device time (ms) of the kernels whose names contain one of
    ``names`` (None: every device kernel), from a torch.profiler run; None
    if it recorded none."""
    total = sum(us for us, key, _n in _kernel_rows(prof)
                if names is None or any(n in key for n in names))
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
    _no_off_path(counts, "hybrid")

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

    # ECC resilience at full width, W8A8: its forward over 4 x 24 tokens
    # runs every linear through B2's tensor-core GEMM
    t0 = time.monotonic()
    kernels.reset_launch_counts()
    (ber, a_ecc, a_raw), = resilience(
        "llama2-7b", reduced=False, device="cuda", seed=0, bers=(HYBRID_BER,),
        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    res_counts = kernels.launch_counts()
    log(f"[hybrid] ecc_resilience llama2-7b full width W8A8, 4x24 tokens, "
        f"BER {ber:g}: top-1 agreement with ECC {a_ecc:.1%}, without ECC "
        f"{a_raw:.1%} ({time.monotonic() - t0:.1f} s); launches {res_counts}")
    if a_ecc < a_raw:
        raise AssertionError("ECC's top-1 agreement is below the raw one")
    for k in ("ecc_decode", "int8_gemm_tc"):
        if res_counts[k] <= 0:
            raise AssertionError(f"the resilience study never launched {k}")
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
    missing = [k for k in ("w4a16_gemv",) + SERVING_KERNELS
               if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the W4A16 serving path never launched "
                             f"{missing}")
    _no_off_path(counts, "serve_w4a16")
    del client, core
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="card,build,kernels,model,serve,profile,hybrid,"
                            "serve_w4a16,serve_hybrid,serve_hybrid_w4a16")
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
    if "serve_hybrid_w4a16" in phases:
        counts["serve_hybrid_w4a16"] = phase_serve_hybrid_w4a16(torch,
                                                                smi_line)
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
                     "library_device_ms": r.get("library_device_ms"),
                     "shape": r.get("shape")})
    log(json.dumps({"kernels": rows}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
