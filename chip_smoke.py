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
            the llama2-7b shapes of the serving path and the smollm-360m
            GQA shapes: the int8 product bit-exact, the attention kernels
            within two bf16 steps of the reference; two planted faults
            (decode attention given a long lane one token or one page
            short) must fail that check.  Times each (CUDA events, median),
            its plain version and one PyTorch library call, beside the
            least time the card could take (bytes at 3.35 TB/s or
            operations at the H100's peak, whichever is larger).
4. model    llama2-7b.reduced() W8A8: the same weights on the card
            (kernels, bf16), on the CPU (plain versions, bf16) and on the
            CPU in float32; at prefill and at each of four decode steps
            the card's logits stay within 1.25x the CPU bf16 run's own
            distance from float32.
5. serve    llama2-7b at full width, W8A8, through the port's serving
            driver (launch/serve.py build_client -> ServingClient ->
            Router -> EngineCore): 8 greedy requests with 64-512-token
            prompts, 32 new tokens each.  Every kernel's launch counter is
            zeroed before and read after; each must be > 0.
6. profile  torch.profiler over 6 decode steps of the same engine: device
            kernel time per step against the host's wall clock, and the
            kernels that take it.

The last three lines are the kernels JSON, nvidia-smi's line and
``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero; without a CUDA device, or without the repository's
``src/repro_torch`` beside it, it exits non-zero before printing a result.
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
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}   # dense tensor-core peaks

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
}

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
            plain = time_ms(torch, lambda i: int8_gemm_ref(x, ws[i]), len(ws))
            lib = None
            if m > 16:  # torch._int_mm takes M > 16 only
                wt = [w.t() for w in ws]
                lib = time_ms(torch, lambda i: torch._int_mm(x, wt[i]),
                              len(ws))
            b_ms, b_by = bound(m * k + n * k + 4 * m * n, 2 * m * n * k,
                               "int8")
            results[variant].update(ms=ms, plain_ms=plain, library_ms=lib,
                                    bound_ms=b_ms, bound_by=b_by,
                                    shape=f"M={m} K={k} N={n}")
            line += (f" | {ms:.4f} ms, plain {plain:.4f} ms, library "
                     f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
                     f"{b_ms:.4f} ms ({b_by})")
        results[variant]["max_abs_err"] = 0.0
        log(line)

    # ---- B1: paged decode attention ---------------------------------------
    page = 16
    for tag, b, h, hkv, d, max_seq, lens in [
            ("llama2-7b", 4, 32, 32, 128, 1024, [1024, 545, 17, 0]),
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
        if tag == "llama2-7b":
            _planted_faults(torch, q, kp, vp, block, lengths, ref, page)
            ms = time_ms(torch, lambda i: paged_decode_attention(
                q, pools[i][0], pools[i][1], block, lengths), n_bufs)
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
            res.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                       bound_by=b_by, shape=f"B={b} H={h} D={d} lens={lens}")
            line += (f" | {ms:.4f} ms, plain {plain:.4f} ms, SDPA on the "
                     f"gathered cache {lib:.4f} ms, bound {b_ms:.4f} ms "
                     f"({b_by})")
        log(line)

    # ---- B3: causal prefill flash attention ---------------------------------
    for tag, b, s, h, hkv, d in [("llama2-7b", 4, 512, 32, 32, 128),
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
        if tag == "llama2-7b":
            ms = time_ms(torch, lambda i: flash_attention(q, k, v))
            plain = time_ms(torch, lambda i: flash_attention_ref(q, k, v))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            bytes_moved = (2 * b * s * h * d + 2 * b * s * hkv * d) * 2
            ops = 4 * b * h * d * s * (s + 1) / 2
            b_ms, b_by = bound(bytes_moved, ops, "bf16")
            res.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                       bound_by=b_by, shape=f"B={b} S={s} H={h} D={d}")
            line += (f" | {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} "
                     f"ms, bound {b_ms:.4f} ms ({b_by})")
        log(line)


def phase_model(torch) -> None:
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.quant.convert import quantize_params

    cfg = get_arch("llama2-7b").reduced()
    params_cpu = quantize_params(M.init_params(cfg, seed=1, device="cpu"))

    def to(tree, dev, f32=False):
        if isinstance(tree, dict):
            return {k: to(v, dev, f32) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev, f32) for v in tree]
        if f32 and tree.dtype == torch.bfloat16:
            tree = tree.float()
        return tree.to(dev)

    runs = {"cpu": (params_cpu, "cpu", torch.bfloat16),
            "cuda": (to(params_cpu, "cuda"), "cuda", torch.bfloat16),
            "f32": (to(params_cpu, "cpu", f32=True), "cpu", torch.float32)}
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
    worst_ratio, worst_card_cpu = 0.0, 0.0
    for i in range(len(logits["cpu"])):
        card, cpu, ref = (logits[k][i] for k in ("cuda", "cpu", "f32"))
        step = "prefill" if i == 0 else f"decode {i}"
        if not bool(torch.isfinite(card).all()):
            raise AssertionError(f"model {step}: non-finite card logits")
        card_cpu = (card - cpu).abs().max().item()
        card_f32 = (card - ref).abs().max().item()
        cpu_f32 = (cpu - ref).abs().max().item()
        ratio = card_f32 / max(cpu_f32, 1e-30)
        worst_ratio = max(worst_ratio, ratio)
        worst_card_cpu = max(worst_card_cpu, card_cpu)
        log(f"[model] {step}: max|dlogit| card-CPU {card_cpu:.3e}, card-f32 "
            f"{card_f32:.3e}, CPU-f32 {cpu_f32:.3e}, ratio {ratio:.3f} "
            f"(|logit| max {ref.abs().max().item():.2f})")
        if ratio > MODEL_RATIO:
            raise AssertionError(
                f"model {step}: card bf16 logits are {card_f32:.3e} from "
                f"float32, more than {MODEL_RATIO} x the CPU bf16 run's "
                f"{cpu_f32:.3e}")
    log(f"[model] llama2-7b.reduced() W8A8: at every step the card is within "
        f"{MODEL_RATIO} x the CPU's own bf16 distance from the float32 run "
        f"(worst ratio {worst_ratio:.3f}); card vs CPU {worst_card_cpu:.3e}")


def phase_serve(torch) -> tuple[dict, object]:
    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch.serve import build_client
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg, client = build_client("llama2-7b", reduced=False, quant="w8a8",
                               max_batch=4, max_seq=1024, seed=0,
                               device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] llama2-7b full width W8A8 built in "
        f"{time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
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
    log(f"[serve] direct prefill of request 0: token {ref_tok} (top-2 margin "
        f"{margin:.4f}); engine's first token {first}")
    if margin > 1e-3 and first != ref_tok:
        raise AssertionError("engine's first token disagrees with a direct "
                             "prefill of the same prompt")
    decode_tokens = stats.tokens_out - len(handles)
    log(f"[serve] 8 requests x 32 tokens: tokens_out={stats.tokens_out} "
        f"prefills={stats.prefills} decode_steps={stats.decode_steps} "
        f"wall {wall:.2f} s")
    log(f"[serve] prefill {stats.wall_prefill_s * 1e3:.1f} ms total "
        f"({stats.wall_prefill_s * 1e3 / max(stats.prefills, 1):.1f} ms per "
        f"group of 4 prompts); decode {decode_tokens} tokens in "
        f"{stats.wall_decode_s:.3f} s = "
        f"{decode_tokens / stats.wall_decode_s:.2f} tok/s "
        f"({stats.wall_decode_s * 1e3 / max(stats.decode_steps, 1):.2f} ms "
        f"per step of 4 slots)")
    log(f"[serve] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; launches {counts}")
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"the serving path never launched {missing}")
    return counts, client


def phase_profile(torch, client) -> None:
    """Where a decode step's time goes: torch.profiler over 6 decode steps
    of 4 slots on the serve phase's engine (after its run), device kernel
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
    log(f"[profile] {steps} decode steps of 4 slots: wall {wall * 1e3 / steps:.2f}"
        f" ms/step (profiled), {launches:.0f} kernel launches/step, device "
        f"kernels {busy * 1e3 / steps:.2f} ms/step, device busy "
        f"{100 * busy / wall:.1f}% of wall")
    if busy <= 0:
        log("[profile] the profiler recorded no device time: not measured")
    for dev_us, key, count in rows[:8]:
        log(f"[profile]   {dev_us / 1e3 / steps:8.3f} ms/step  {count // steps:5d}"
            f" calls/step  {key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="card,build,kernels,model,serve,profile")
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
    counts = None   # launch counts are read only around the serve phase's run
    if "serve" in phases:
        counts, client = phase_serve(torch)
        if "profile" in phases:
            phase_profile(torch, client)
    rows = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": None if counts is None else counts[name],
                     "max_abs_err": r.get("max_abs_err"),
                     "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
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
