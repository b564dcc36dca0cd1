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
            64-byte K slab skipped.  B2 also at whisper-small's encoder
            (M 6,000, K 768 and 3,072) and mamba2-130m's projections (N
            3,352), bit-exact.  B3's bidirectional mode
            (flash_attention_bidir) at whisper-small's encoder (B 4, S
            1,500, H 12, D 64) and cross-attention (Sq 128, Skv 1,500)
            shapes, the reduced config's 16 keys, a ragged GQA Skv 77 and D
            112, with two planted faults that must fail (TMA's zero keys
            past Skv left unmasked, the last K/V block dropped); B1 over the
            contiguous wave cache (``decode_attention``) at whisper's
            self-attention (lengths up to 448) and cross-attention (1,500)
            and llama2-7b's wave decode.  Decode attention is also checked at
            the split edges (lengths 1, 63, 64, 65, 1024) and for a
            slot's bits alone, in its batch and under a wider block table,
            and at query groups of 16 (chatglm3-6b: H 32 over Hkv 2) and
            12 (command-r-plus-104b: H 96 over 8), which the kernel runs
            in two passes of up to 8 heads, over bf16 and int8 pools: the
            planted faults, batch invariance, a group of 16 (12) bit-equal
            to its heads in groups of 8 + 8 (8 + 4, 6 + 6), and groups 1-8
            bit-equal to B1 as it was while it took groups of up to 8
            (``csrc/diag/decode_attention_groups8.cu``, built beside the
            library by the build phase; ``kernels/diag_b1_bits.py``).
            B3 also at chatglm3-6b's prefill (B 4, S 512, H 32 over 2).
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
11. serve_overlap  the one-dispatch decode: llama2-7b W8A8 at full width,
            4 slots, through build_client (synchronous loop) and a
            ServingClient with overlap=True on the same weights.  8 greedy
            requests of 64-512 tokens, 32 new each, give identical streams
            run eagerly (graphs.disabled()), synchronous over replayed CUDA
            graphs, and overlapped; 8 with every second one stochastic
            (temperature 0.8, top-k 20, top-p 0.9, fixed seeds) the same
            synchronous and overlapped.  Every decode step of a graph run
            is one replay; 2 dispatches a step synchronous, 1 overlapped;
            B1 and the GeMV counted through replays.  Prints the decode
            wall ms a step three ways (a synchronized clock around the
            decode loop of 4 slots), host launch calls a step and the
            device's busy share: torch.profiler's device kernel ms a step
            (6 steps) over that wall ms, and over the profiled window's own
            wall, which the profiler stretches; and the overlapped wall
            with every row sampled.  Then zamba2-7b W8A8: 4 greedy
            requests of 16 tokens, synchronous and overlapped identical,
            and its decode wall ms a step synchronous and overlapped.
12. serve_chunked  llama2-7b W8A8 at full width, cut to its first 8
            layers, through build_client(chunk_prefill=128): the serve
            trace (counted: the chunk kernel once a layer a chunk),
            synchronous and overlapped identical; on 12
            prompts the one-shot (B3) and chunked paths' logits and the two
            engines' streams bit-equal; a
            150-token prompt through the chunk path at budgets {1, 7, 16,
            128, 150}: valid K/V rows, first-token logits and 5 decode
            logits bit-equal (and whether torch's rms_norm gives a row
            other bits at another row count); a 64-token request emitting
            a token on every step while a 512-token prompt takes 4 chunks,
            each step's wall with and without a chunk; ms per chunk and
            device ms at 16, 128 and 512 tokens.
13. serve_int8kv  the same (8 layers) with kv_dtype="int8": the serve
            trace (counted: B1's int8 variant, never B1 over bf16), the first
            token against a direct prefill, synchronous and overlapped
            identical greedy and sampled, the bf16 engine's streams on
            margin-checked prompts, chunked == one-shot under int8 at
            budgets {7, 16, 128, 150}, a chunked int8 engine (counted: the
            chunk kernel's int8 variant), the pool's bytes a token, and the
            prefill and decode profiles.
14. serve_tiered  llama2-7b W8A8 at full width, 4 slots, kv_tier="flash"
            over a 65-page hot pool (1,024 tokens; a page is 8 MiB) under
            the serve trace (up to 4 x 544 tokens): streams bit-equal to
            the resident engine's, synchronous and overlapped, with spills,
            prefetches and preemptions; a tier bounded to 16 pages finishes
            every request; the same under int8 pools; ms a page each way
            (synchronized) and the decode wall a step against the resident
            engine's.  Then zamba2-7b over a 41-page pool: 4 requests equal
            the resident engine's, the Mamba state restored on resume.
15. serve_prefix  llama2-7b (its first 8 layers at full width) with
            prefix_cache=True on the JAX benchmark's
            chat trace (4 sessions, 3 turns, a 992-token system prompt,
            every turn submitted twice): resume hits equal their cold run
            with no prefill; all 24 streams equal the cold one-shot
            engine's, partial hits (the chunk kernel over B3's pages)
            included, and with a chunk budget of 256 (every prompt chunks)
            the cold chunked engine's; on 8 more prompts a partial hit over
            one-shot pages gives the one-shot logits and stream bit for
            bit; refcounts back to idle; B1 and the chunk kernel counted;
            TTFT p50 cold and warm, prefill device ms cold against a
            partial hit's suffix.
16. serve_migrate  two llama2-7b replicas on the card sharing one params
            dict behind Router(migrate=True): every request on a starved
            tiered replica, the router drains it into a donor; streams
            equal one resident replica's, synchronous and overlapped; a
            snapshot's bytes decode to equal pages and resume with the
            unmigrated stream; bytes a snapshot, ms to snapshot and inject.
17. serve_fleet  llama2-7b W8A8 at full width (4 slots a worker, max_seq
            1024, the serve trace, 32 new tokens, odd rids sampled with
            pinned seeds) through FleetRouter: loopback fleets (on its
            first 8 of 32 layers, as the sanitized engine) of 2
            workers + 1 spare sharing one params dict, checkpoints every 8
            steps, worker 0 killed after step 10, synchronous and
            overlapped (no request lost, one engine's streams bit for bit,
            one worker lost, one failover, the spare promoted; the serving
            kernels counted); undisturbed fleets with and without
            checkpoints beside one engine (tok/s); the straggler watchdog
            flagging decode steps 3 and 7 over llama2-7b and zamba2-7b
            (the unwatched streams, two events, the re-dispatch's ms);
            REPRO_SANITIZE=1 over an overlapped + tiered + prefix-cache
            engine (the plain streams, no report); 2 socket workers that
            build llama2-7b themselves on the card, one SIGKILLed (the
            parent's streams).  Prints a checkpoint's bytes and ms (worker
            snapshots, the wire, save_checkpoint), recovery s, tokens
            replayed and a worker's start-up s.
18. serve_wave  wave mode at full width, W8A8, 4 slots, through
            build_client: whisper-small (mode "auto" picks wave; max_seq
            448, its decoder context; the serve trace's prompts cut to
            128 tokens; frames of zeros) and mamba2-130m (max_seq 1024),
            then llama2-7b and zamba2-7b asked for mode="wave": 8 greedy
            requests, 32 new tokens each.  Each model's first run,
            synchronous over graphs, is counted (whisper-small must launch
            B3's bidirectional mode, B3, B1 and B2; mamba2-130m B6 and B2)
            and the same requests run eagerly (graphs.disabled()) give the
            same streams; the engine's first tokens equal a direct
            prefill's.  whisper-small and mamba2-130m also run overlapped
            (the same streams) and with every second request sampled
            (synchronous == overlapped), and one prompt's wave prefill
            logits pass the model phase's CPU gate (1.25x).  Prints tok/s,
            prefill ms a wave, decode wall ms a step and the launches.
19. serve_moe  qwen2-moe-a2.7b at full width (its first 8 of 24 layers,
            d_model 2048, 60 routed experts padded to 64, top-4, 4 shared
            experts),
            W8A8 (the routed experts bf16), 4 slots, max_seq 1024, page
            16, through build_client: the serve trace (counted: the
            grouped GEMM, 3 launches a layer inside the decode graph);
            graph == eager == overlapped, greedy, and sampled synchronous
            == overlapped; a chunk budget of 128 gives the one-shot
            logits and streams bit for bit on 6 prompts and chunked ==
            one chunk at budgets {16, 128, 150}; a request admitted while
            three others decode gives its solo stream; 3 partial prefix
            hits equal cold runs (logits and streams); a wave-mode run's
            first tokens equal a direct prefill's; the CPU gate on 2
            layers at full width, with each layer's smallest router
            k-th / (k+1)-th logit gap and the rows whose experts differ
            between the runs.  Prints decode ms a step and tok/s (sync,
            overlapped), prefill ms a group, the profiles (the grouped
            GEMM's device ms a step and a group), peak memory.
20. serve_dense  chatglm3-6b at full width (its first 8 of 28 layers,
            d_model 4096, 32 query heads over 2 kv heads: B1's group of
            16 in the decode
            graph; rotary on half of each head; q/k/v and FFN biases), then
            internlm2-20b (its first 8 of 48 layers, d_model 6144, 48
            heads over 8),
            the paper's llama2-70b (its first 8 of 80 layers, d_model 8192,
            64 heads over 8) and the parallel-block command-r-plus-104b
            (its first 44 of 64 layers, d_model 12,288, 96 heads over 8:
            B1's group of 12; d_ff 33,792; a tied 256,000 x 12,288
            embedding; 69.2 GB of layers built layer by layer, the deepest
            cut the card holds: the whole model's 100.7 GB of W8A8 layers
            do not fit it), W8A8,
            4 slots, max_seq 1024, page 16, through build_client: the serve
            trace (counted: B1-B3, B1 once a layer a step inside the decode
            graph), the first token a direct prefill's, graph == eager;
            chatglm3-6b and command-r-plus-104b also overlapped == eager,
            sampled synchronous == overlapped, a chunk budget of 128
            giving the one-shot logits and streams bit for bit (the chunk
            kernel at groups 16 and 12 counted) and 3 partial prefix hits
            equal to cold runs; each the CPU gate on 2 layers at full
            width (the host's free memory printed before it).  Prints
            decode ms a step and tok/s (sync, overlapped), prefill ms a
            group, the profiles (B1's device ms a step), the resident
            weights and pools, the build's and the phase's peak memory.
21. serve_mla  deepseek-v2-lite-16b at full width (its first 8 of 27
            layers, the first dense, d_model 2048, 16 heads of multi-head
            latent attention:
            R 512, qk head 128 + 64, v 128; 64 routed experts top-6, 2
            shared; vocab 102,400), W8A8 (the routed experts bf16), 4
            slots, max_seq 1024, page 16, through build_client: the serve
            trace (counted: B2, B3 at the qk head of 192, the grouped GEMM
            and the MLA decode kernel, one launch a layer inside the decode
            graph; B1 never); graph == eager == overlapped, greedy, and
            sampled synchronous == overlapped; int8 pools (counted: the MLA
            kernel's int8 variant; overlapped == synchronous; the bf16
            engine's streams on margin-checked prompts); tiered ==
            resident over a 65-page hot pool; a snapshot's bytes resumed on
            another engine == the unmigrated stream; a resume hit == its
            cold run; a wave run (the MLA kernel over the contiguous cache)
            whose first tokens equal a direct prefill's; the CPU gate on 2
            layers (the dense one and a MoE one) at full width.  Prints
            decode ms a step and tok/s (sync, overlapped), prefill ms a
            group, the profiles (the MLA kernel's device ms a step), peak
            memory; the decode profile must hold one MLA device kernel a
            layer-step (the merge of the splits fused into it).
22. serve_vlm  qwen2-vl-72b at full width (its first 20 of 80 layers,
            d_model 8192, 64
            query heads over 8 kv heads, q/k/v and FFN biases, d_ff
            29,568, vocab 152,064, M-RoPE over 256 prepended vision
            embeddings, zeros as the engine feeds them), W8A8 built on
            the card layer by layer from seed 0 (21.3 GB of weights), 4
            slots, max_seq 1024, page 16, through build_client: the serve
            trace (counted: B1 once a layer inside the decode graph, B2,
            B3 over 320-768 rows); graph == overlapped, == eager on the
            first group, and sampled synchronous == overlapped; int8 pools
            (counted: B1's int8 variant; the int8 engine == the direct
            int8 path on margin-checked prompts, == the bf16 engine where
            both paths keep their margins and tokens; overlapped ==
            synchronous); tiered == resident over a 65-page hot pool; a
            snapshot's bytes resumed on another engine == the unmigrated
            stream; a resume hit == cold through the vision rows'
            sentinel keys; a wave run's first tokens == a direct
            prefill's; the CPU gate on 2 layers at full width.  One engine
            at a time beside the weights.  Prints the build's time and peak
            against the resident bytes and memory.total, decode ms a step
            and tok/s (sync, overlapped), prefill ms a group, the
            profiles (B1's and the GeMV's device ms a step).

Every serving phase's engine replays one CUDA graph a decode step
(``serving/graphs.py``); the launch counters count each replay's kernels.

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
yardstick that rounds the scales and the output to bf16.  The paged chunk
kernel (bf16 and int8 pools, D 128 and 112, chunks of 1, 7 in a bucket of
16, 16 and 128 rows at starts 0, 5 and 300; at H 32 over Hkv 2, C 128 from
0 and 300) within ATTN_TOL of its plain
version (the JAX float32 formula), every valid query bit-equal to B3's
output in the one-shot run over the same keys (bf16 pools) and to the
same query in one chunk from 0, padding rows 0, and a key one past a
query's position changed without moving that query; timed at C 128 from
0 and 300 (bf16, int8; H 32 over 32 and over 2), C 16 from 992 and C 512
from 0 beside SDPA over
the gathered (int8: dequantized) rows and B3 over the one-shot run.  B1
over int8 pools against its plain version with B1's planted faults and
batch invariance (also at groups 16 and 12), timed beside SDPA.  The
grouped GEMM (the moe
family's ragged_dot) at qwen2-moe-a2.7b's up and down shapes over 64
experts: decode (16 rows on 16 experts, 16 on one), prefill (8,192 rows
of a real routing), a skew (8,192 rows on one expert) and the tile edges
(groups of 63, 64, 65, 127, 128 and 129 rows, an empty expert between
two full 128-row tiles, 37 rows past the groups' sum), within GG_TOL of
its plain version, rows past the groups' sum 0, a row's bits the same
alone and in groups of 2 to 8,192 rows (the tile edges among them) at
both shapes, a planted fault (a group offset off by one) that must fail;
timed beside torch._grouped_mm (or, where this torch lacks it, a
per-expert matmul loop).  B3 at deepseek-v2-lite-16b's MLA prefill (B 4,
S 512, H 16, D 192: the qk head, v padded to it) and its reduced qk head
of 24, within ATTN_TOL, with B3's two planted faults.  The MLA decode
kernel at deepseek-v2-lite-16b's shapes (B 4, H 16, R 512, Dr 64, page
16, a 64-page table) over bf16 and int8 pools, lengths 1024 / 545 / 17 /
0, the serve trace's and the split edges 1 / 63 / 64 / 65, within MLA_TOL
of its plain version (JAX's float32 formula), a length-0 lane 0, two
planted faults that must fail (lane 0 one page short, every lane's last
split of 64 keys dropped), a slot's bits alone, in its batch and under a
wider table; timed beside its bound (bytes, or 3x the operations on the
bf16 tensor cores: the kernel's instruction mix, each float32 product as
three bf16 ones; the float32 CUDA-core bound printed beside it), SDPA over the gathered, dequantized float32 rows with a
length mask, and, in turns in the same call, the kernel it replaced (the
CUDA-core split and combine kernels of PR 27,
``csrc/diag/mla_decode_attention_pr27.cu``, built beside the library by
the build phase; ``kernels/diag_mla.py``).

The last three lines are the kernels JSON, nvidia-smi's line and
``{"ok": true, "device": {...}}``; each kernel's ``launches`` is read
around the run of the phase that owns it (serve for B1-B3, serve_wave
for B3's bidirectional mode, hybrid for B5, serve_hybrid_w4a16 for B4's two variants, serve_hybrid for B6,
serve_chunked for the chunk kernel, serve_int8kv for B1-int8 and its
chunked engine for the chunk kernel's int8 variant, serve_moe for the
grouped GEMM, serve_mla for the MLA kernel, bf16 and int8; serve_vlm
prints its own counts of B1-B3).  B2's __dp4a GeMV and
tiled GEMM (``int8_gemv_dp4a``, ``int8_gemm``) are on no model's path
(every model K is a multiple of 16 and every base aligned): a serving
phase that launches either fails.  Any failure
raises and the script exits non-zero; without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero before
printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
    "flash_attention_bidir": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:59"),
    "w4a16_gemv": ("src/repro_torch/kernels/csrc/w4a16_gemv.cu",
                   "src/repro/kernels/w4a16_gemv/w4a16_gemv.py:43"),
    "w4a16_gemm": ("src/repro_torch/kernels/csrc/w4a16_gemv.cu",
                   "src/repro/kernels/w4a16_gemv/w4a16_gemv.py:43"),
    "ecc_decode": ("src/repro_torch/kernels/csrc/ecc_decode.cu",
                   "src/repro/kernels/ecc_decode/ecc_decode.py:53"),
    "ssd_intra_chunk": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan/ssd_scan.py:43"),
    "paged_decode_attention_int8": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:61"),
    # no Pallas counterpart: the JAX package computes it in jnp
    "paged_chunk_attention": (
        "src/repro_torch/kernels/csrc/paged_chunk_attention.cu",
        "src/repro/models/attention.py:233"),
    "paged_chunk_attention_int8": (
        "src/repro_torch/kernels/csrc/paged_chunk_attention.cu",
        "src/repro/models/attention.py:233"),
    # no Pallas counterpart: jax.lax.ragged_dot in the MoE layer
    "grouped_gemm": ("src/repro_torch/kernels/csrc/grouped_gemm.cu",
                     "src/repro/models/moe.py:80"),
    # no Pallas counterpart: the jnp einsums of _mla_absorbed_attend
    "mla_decode_attention": (
        "src/repro_torch/kernels/csrc/mla_decode_attention.cu",
        "src/repro/models/blocks.py:325"),
    "mla_decode_attention_int8": (
        "src/repro_torch/kernels/csrc/mla_decode_attention.cu",
        "src/repro/models/blocks.py:325"),
}
# the phase whose run each kernel's launch count is read around
COUNTED_IN = {"int8_gemv": "serve", "int8_gemv_dp4a": "serve",
              "int8_gemm": "serve", "int8_gemm_tc": "serve",
              "paged_decode_attention": "serve", "flash_attention": "serve",
              "ecc_decode": "hybrid", "w4a16_gemv": "serve_hybrid_w4a16",
              "w4a16_gemm": "serve_hybrid_w4a16",
              "ssd_intra_chunk": "serve_hybrid",
              "paged_chunk_attention": "serve_chunked",
              "flash_attention_bidir": "serve_wave",
              "paged_decode_attention_int8": "serve_int8kv",
              "paged_chunk_attention_int8": "serve_int8kv_chunked",
              "grouped_gemm": "serve_moe",
              "mla_decode_attention": "serve_mla",
              "mla_decode_attention_int8": "serve_mla_int8"}
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
                "paged_decode_attention_int8": "paged_decode_attention_",
                "paged_chunk_attention": "paged_chunk_attention_",
                "paged_chunk_attention_int8": "paged_chunk_attention_",
                "w4a16_gemv": "w4a16_gemv_mma_kernel",
                "w4a16_gemm": "w4a16_gemm_",
                "grouped_gemm": "grouped_gemm_kernel",
                "mla_decode_attention": "mla_decode_",
                "mla_decode_attention_int8": "mla_decode_"}
# the kernels every W8A8 serving phase must go through; the mla_moe
# family's decode attention is the MLA kernel instead of B1
SERVING_KERNELS = ("int8_gemv", "int8_gemm_tc", "paged_decode_attention",
                   "flash_attention")
MLA_SERVING = ("int8_gemv", "int8_gemm_tc", "flash_attention",
               "grouped_gemm", "mla_decode_attention")

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
# the depth of the earlier paths whose gates hold at any depth (the
# bit-equalities of engines and paths, the launch counts a layer):
# serve_chunked, serve_int8kv, serve_prefix, serve_fleet's loopback fleets,
# serve_moe, serve_mla and serve_dense's chatglm3-6b, internlm2-20b and
# llama2-70b run their model's first CUT_LAYERS layers at full width, and
# serve_vlm qwen2-vl-72b's first VLM_LAYERS, so the whole script stays well
# inside its time limit on a slow host beside command-r-plus-104b's
# COMMAND_R_LAYERS
CUT_LAYERS = 8
VLM_LAYERS = 20
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
    from repro_torch.kernels import build, diag_b1_bits, diag_mla

    t0 = time.monotonic()
    # B1 as it was while it took groups of up to 8, for the kernels phase's
    # bit comparison, and the MLA kernel as it was before its tensor-core
    # redesign, for its timing, built beside the library
    proc = diag_b1_bits.start_build()
    proc_mla = diag_mla.start_build()
    b = build.build()
    build.library()
    _B1_GROUPS8.append(diag_b1_bits.load(proc))
    _MLA_PR27.append(diag_mla.load(proc_mla))
    log(f"[build] {b.path.name} {'built' if b.built else 'reused'}, and "
        f"B1's groups-of-8 build for the bit comparison and the PR 27 MLA "
        f"kernel for its timing, in {time.monotonic() - t0:.1f} s")
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


# the library of csrc/diag/decode_attention_groups8.cu, once built
_B1_GROUPS8: list = []
# the library of csrc/diag/mla_decode_attention_pr27.cu, once built
_MLA_PR27: list = []


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


def _kernels_b1_groups(torch) -> None:
    """B1 at query groups above 8 runs the group-of-8 arithmetic in two
    passes, so a head's bits must not depend on its group: a group of 16
    (12) over one kv head equals, bit for bit, the same queries cut into
    two calls of 8 + 8 (8 + 4, 6 + 6) over the same pools, over bf16 and
    int8 pools, at the split edges.  Then groups 1-8 against B1 as it was
    while it took groups of up to 8 only (``kernels/diag_b1_bits.py``,
    built beside the library by the build phase): every output bit for
    bit."""
    from repro_torch.kernels import diag_b1_bits
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import SPLIT

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    lens = [1024, 545, 17, 0, 1, SPLIT - 1, SPLIT, SPLIT + 1]
    b, d, page, pps = len(lens), 128, 16, 64
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    n_pages = b * pps + 1
    kp, vp = (torch.randn((n_pages, page, 1, d), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    block = (torch.randperm(n_pages - 1, generator=gen, device=dev)
             + 1).reshape(b, pps).to(torch.int32)
    for kv, pools in (("bf16", (kp, vp)),
                      ("int8", (_quantized(kp), _quantized(vp)))):
        for h, cut in ((16, 8), (12, 8), (12, 6)):
            q = torch.randn((b, h, d), generator=gen, device=dev).to(
                torch.bfloat16)
            whole = paged_decode_attention(q, *pools, block, lengths)
            parts = torch.cat([
                paged_decode_attention(q[:, :cut].contiguous(), *pools,
                                       block, lengths),
                paged_decode_attention(q[:, cut:].contiguous(), *pools,
                                       block, lengths)], dim=1)
            torch.cuda.synchronize()
            same = torch.equal(whole, parts)
            log(f"[kernels] paged_decode_attention {kv} pools, a group of "
                f"{h} over one kv head (D {d}, lens {lens}) against the same "
                f"queries in groups of {cut} + {h - cut}: "
                f"{'bit-identical' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError(f"B1: a head's bits depend on its group "
                                     f"({h} against {cut} + {h - cut}, {kv})")
    dll = _B1_GROUPS8[0] if _B1_GROUPS8 else diag_b1_bits.load()
    bad = diag_b1_bits.compare(torch, dll, log)
    if bad:
        raise AssertionError(f"B1 at groups 1-8: {bad} outputs differ from "
                             f"the groups-of-8 build")
    log(f"[kernels] paged_decode_attention at groups 1-8: every output of "
        f"{2 * len(diag_b1_bits.CASES)} cases bit-identical to B1 as it was "
        f"while it took groups of up to 8 only")


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


def _bidir_faults(torch, q, k, v, ref) -> None:
    """What B3's bidirectional mode computes with a planted fault, in
    float32 on the card, rounded to bf16: the keys TMA fills with zeros
    past Skv (up to the next multiple of 64) left unmasked, each scoring 0
    with a zero value row, or the last K/V block dropped.  The attention
    check must reject both."""
    b, s, h, d = q.shape
    skv = k.shape[1]
    rep = h // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (t.float().repeat_interleave(rep, dim=2).transpose(1, 2)
              for t in (k, v))
    sc = (qf @ kf.transpose(-1, -2)) * d ** -0.5
    pad = -skv % 64
    zeros = sc.new_zeros((*sc.shape[:-1], pad))
    faults = (("keys past Skv unmasked (TMA's zero rows)",
               torch.cat([sc, zeros], -1),
               torch.cat([vf, vf.new_zeros((b, h, pad, d))], 2)),
              ("last K/V block dropped",
               sc[..., :(skv - 1) // 64 * 64], vf[:, :, :(skv - 1) // 64 * 64]))
    for fault, scores, vals in faults:
        if scores.shape[-1] == 0:
            continue
        bad = (torch.softmax(scores, -1) @ vals).transpose(1, 2).to(q.dtype)
        err, limit = _attn_errors(torch, bad, ref)
        caught = int((err > limit).sum())
        log(f"[kernels] planted fault, flash_attention_bidir with its "
            f"{fault} (B={b} S={s} Skv={skv} H={h} D={d}): {caught} of "
            f"{err.numel()} outputs above {ATTN_TOL}, max|err| "
            f"{err.max().item():.3e}")
        if caught == 0:
            raise AssertionError(f"planted fault ({fault}) passes the "
                                 f"flash_attention_bidir check")


# B3 bidirectional: (tag, B, Sq, Skv, H, Hkv, D); the whisper rows timed
BIDIR_CASES = [("whisper encoder", 4, 1500, 1500, 12, 12, 64),
               ("whisper cross", 4, 128, 1500, 12, 12, 64),
               ("reduced encoder", 4, 16, 16, 4, 2, 16),
               ("reduced cross", 4, 9, 16, 4, 2, 16),
               ("ragged GQA cross", 2, 200, 77, 8, 2, 128),
               ("D 112, Skv 300", 2, 130, 300, 8, 8, 112)]


def _kernels_bidir(torch, results: dict, randn) -> None:
    """B3's bidirectional mode against its plain version (the model's
    chunked attention, causal=False) at the whisper-small encoder and
    cross-attention shapes, the reduced config's and ragged GQA / D 112
    shapes; the two whisper shapes timed beside SDPA and their bound, with
    the planted faults."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    res = results["flash_attention_bidir"]
    for tag, b, s, skv, h, hkv, d in BIDIR_CASES:
        q, k, v = randn(b, s, h, d), randn(b, skv, hkv, d), randn(b, skv, hkv, d)
        got = flash_attention(q, k, v, causal=False)
        ref = flash_attention_ref(q, k, v, causal=False)
        torch.cuda.synchronize()
        err, used = _check_close(torch, f"flash_attention_bidir[{tag}]", got,
                                 ref)
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
        line = (f"[kernels] flash_attention_bidir {tag} B={b} S={s} Skv={skv} "
                f"H={h} Hkv={hkv} D={d}: max|err| {err:.3e} (worst "
                f"|err|/limit {used:.3f}; tol {ATTN_TOL})")
        if tag.startswith("whisper"):
            fn = lambda i: flash_attention(q, k, v, causal=False)  # noqa: E731
            ms = time_ms(torch, fn)
            dev_ms = profiled_ms(torch, fn, ("flash_attention",))
            plain = time_ms(torch, lambda i: flash_attention_ref(
                q, k, v, causal=False))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                qt, kt, vt))
            lib_dev = profiled_ms(torch, lambda i: F.scaled_dot_product_attention(
                qt, kt, vt))
            bytes_moved = (2 * b * s * h * d + 2 * b * skv * hkv * d) * 2
            b_ms, b_by = bound(bytes_moved, 4 * b * h * d * s * skv, "bf16")
            if tag == "whisper encoder":
                res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                           library_ms=lib, library_device_ms=lib_dev,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"B={b} S={s} Skv={skv} H={h} D={d}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms, "
                     f"{100 * b_ms / dev_ms:.1f}% of the bound), plain "
                     f"{plain:.4f} ms, SDPA {lib:.4f} ms (device {lib_dev:.4f} "
                     f"ms), bound {b_ms:.4f} ms ({b_by})")
        log(line)
        if tag.startswith("whisper"):
            _bidir_faults(torch, q, k, v, ref)


def _kernels_b1_contiguous(torch, results: dict, randn) -> None:
    """B1 over the wave engine's contiguous cache [B, Smax, Hkv, D], read
    as B pages of Smax rows (``decode_attention``), against the plain
    ``models.attention.decode_attention``: whisper-small's decoder
    self-attention (lengths up to 448), its cross-attention over 1,500
    encoder rows, and llama2-7b's wave decode; the whisper shapes timed
    beside SDPA with a length mask and their bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dev = torch.device("cuda")
    for tag, b, h, d, smax, lens in [
            ("whisper self", 4, 12, 64, 448, [448, 300, 129, 1]),
            ("whisper cross", 4, 12, 64, 1500, [1500] * 4),
            ("llama2-7b wave", 4, 32, 128, 1024, [611] * 4)]:
        kc, vc = randn(b, smax, h, d), randn(b, smax, h, d)
        q = randn(b, h, d)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = decode_attention(q, kc, vc, lengths)
        ref = decode_attention_ref(q, kc, vc, lengths)
        torch.cuda.synchronize()
        err, used = _check_close(torch, f"decode_attention[{tag}]", got, ref)
        line = (f"[kernels] decode_attention (B1, contiguous cache) {tag} "
                f"B={b} H={h} D={d} Smax={smax} lens={lens}: max|err| "
                f"{err:.3e} (worst |err|/limit {used:.3f}; tol {ATTN_TOL})")
        if tag.startswith("whisper"):
            fn = lambda i: decode_attention(q, kc, vc, lengths)  # noqa: E731
            ms = time_ms(torch, fn)
            dev_ms = profiled_ms(torch, fn,
                                 (KERNEL_NAMES["paged_decode_attention"],))
            plain = time_ms(torch, lambda i: decode_attention_ref(
                q, kc, vc, lengths))
            kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
            mask = (torch.arange(smax, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                q4, kt, vt, attn_mask=mask))
            lib_dev = profiled_ms(torch, lambda i: F.scaled_dot_product_attention(
                q4, kt, vt, attn_mask=mask))
            n_tok = sum(lens)
            b_ms, b_by = bound(2 * b * h * d * 2 + n_tok * h * d * 4 + b * 4,
                               4 * n_tok * h * d, "bf16")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms), plain "
                     f"{plain:.4f} ms, SDPA {lib:.4f} ms (device {lib_dev:.4f} "
                     f"ms), bound {b_ms:.4f} ms ({b_by})")
        log(line)


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
              (2048, 4104, 11008), (4, 4104, 11008),
              # whisper-small's encoder over 4 x 1,500 frames (K 768 and
              # 3072) and decoder; mamba2-130m's in_proj (N 3352) and
              # out_proj at prefill and decode
              (6000, 768, 768), (6000, 768, 3072), (6000, 3072, 768),
              (4, 768, 3072), (2048, 768, 3352), (4, 768, 3352),
              (4, 1536, 768),
              # qwen2-vl-72b's gate/up and down at decode and gate/up over
              # a prefill group of 4 x 768 rows (256 vision rows each)
              (4, 8192, 29568), (4, 29568, 8192), (3072, 8192, 29568),
              # command-r-plus-104b's gate/up and down at decode and
              # gate/up over a prefill group of 4 x 512 rows
              (4, 12288, 33792), (4, 33792, 12288), (2048, 12288, 33792)]
    timed_b2 = {(4, 4096, 4096): "llama2-7b q/k/v/o",
                (4, 4096, 11008): "llama2-7b gate/up",
                (4, 11008, 4096): "llama2-7b down",
                (4, 3584, 14576): "zamba2-7b in_proj",
                (4, 7168, 3584): "zamba2-7b out_proj",
                (2048, 4096, 11008): "llama2-7b",
                (2048, 3584, 14576): "zamba2-7b in_proj",
                (2048, 4104, 11008): "off every model path, K % 16 == 8",
                (4, 4104, 11008): "off every model path, K % 16 == 8",
                (6000, 768, 3072): "whisper-small encoder up",
                (2048, 768, 3352): "mamba2-130m in_proj",
                (4, 8192, 29568): "qwen2-vl-72b gate/up",
                (4, 29568, 8192): "qwen2-vl-72b down",
                (3072, 8192, 29568): "qwen2-vl-72b gate/up",
                (4, 12288, 33792): "command-r-plus-104b gate/up",
                (4, 33792, 12288): "command-r-plus-104b down",
                (2048, 12288, 33792): "command-r-plus-104b gate/up"}
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
             "serve group 2, D 112", "chatglm3-6b", "command-r-plus-104b",
             "deepseek-v2-lite-16b", "qwen2-vl-72b",
             "qwen2-vl-72b serve group 1", "qwen2-vl-72b serve group 2")
    faulted = ("llama2-7b", "zamba2-7b", "chatglm3-6b", "command-r-plus-104b",
               "qwen2-vl-72b serve group 2")
    edges = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 1024]
    for tag, b, h, hkv, d, max_seq, lens in [
            ("llama2-7b", 4, 32, 32, 128, 1024, [1024, 545, 17, 0]),
            ("zamba2-7b", 4, 32, 32, 112, 1024, [1024, 545, 17, 0]),
            ("smollm-360m", 4, 15, 5, 64, 1024, [700, 64, 1, 0]),
            # query groups of 16 and 12: two passes of up to 8 heads
            ("chatglm3-6b", 4, 32, 2, 128, 1024, [1024, 545, 17, 0]),
            ("command-r-plus-104b", 4, 96, 8, 128, 1024, [1024, 545, 17, 0]),
            ("split edges", 6, 32, 32, 128, 1024, edges),
            ("split edges, D 112", 6, 32, 32, 112, 1024, edges),
            ("split edges, group 16", 6, 32, 2, 128, 1024, edges),
            ("split edges, group 12", 6, 96, 8, 128, 1024, edges),
            ("serve group 1", 4, 32, 32, 128, 1024, [252, 127, 197, 272]),
            ("serve group 2", 4, 32, 32, 128, 1024, [403, 331, 275, 439]),
            ("serve group 2, D 112", 4, 32, 32, 112, 1024,
             [403, 331, 275, 439]),
            # qwen2-vl-72b: 64 heads over 8, the serve trace's groups with
            # 256 vision rows before each prompt
            ("qwen2-vl-72b serve group 1", 4, 64, 8, 128, 1024,
             [508, 383, 453, 528]),
            ("qwen2-vl-72b serve group 2", 4, 64, 8, 128, 1024,
             [659, 587, 531, 695])]:
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
            gqa = {"enable_gqa": True} if h != hkv else {}
            lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                q4, kd[i], vd[i], attn_mask=mask, **gqa), n_bufs)
            lib_dev = profiled_ms(
                torch, lambda i: F.scaled_dot_product_attention(
                    q4, kd[i], vd[i], attn_mask=mask, **gqa), None, n_bufs)
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
    _kernels_b1_groups(torch)

    # ---- B3: causal prefill flash attention ---------------------------------
    for tag, b, s, h, hkv, d in [("llama2-7b", 4, 512, 32, 32, 128),
                                 ("zamba2-7b", 4, 512, 32, 32, 112),
                                 ("smollm-360m", 4, 512, 15, 5, 64),
                                 ("chatglm3-6b", 4, 512, 32, 2, 128),
                                 # a group of 4 prompts of 512 tokens
                                 # after 256 vision rows
                                 ("qwen2-vl-72b", 4, 768, 64, 8, 128),
                                 # a group of 4 prompts of 512 tokens at
                                 # 96 heads over 8
                                 ("command-r-plus-104b", 4, 512, 96, 8,
                                  128),
                                 ("ragged", 2, 200, 8, 2, 128),
                                 ("reduced", 4, 32, 4, 4, 16),
                                 # MLA's prefill: qk head 128 + 64, v
                                 # padded to it; the reduced 16 + 8
                                 ("deepseek-v2-lite-16b", 4, 512, 16, 16,
                                  192),
                                 ("deepseek-v2-lite-16b reduced", 2, 100, 4,
                                  4, 24)]:
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
            gqa = {"enable_gqa": True} if h != hkv else {}
            lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, **gqa))
            lib_dev = profiled_ms(
                torch, lambda i: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, **gqa))
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
        if tag in timed or tag.startswith("deepseek"):
            _flash_faults(torch, q, k, v, ref)
    _kernels_bidir(torch, results, randn)
    _kernels_b1_contiguous(torch, results, randn)

    _kernels_ecc(torch, results)
    _kernels_w4a16(torch, results)
    _kernels_ssd(torch, results)
    _kernels_b1_int8(torch, results)
    _kernels_chunk(torch, results)
    _kernels_grouped(torch, results)
    _kernels_mla(torch, results)


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
# bf16 and in float32 x.  Timed (bf16 x; float32 too at the W4_JSON shapes)
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
                dt == torch.bfloat16 or (m, k, n) in W4_JSON.values())
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


# ---------------------------------------------------------------------------
# the paged chunk kernel and the int8 pools (B1's int8 variant)
# ---------------------------------------------------------------------------

# the paged chunk kernel: chunks of 1, 7 (in a bucket of 16), 16 and 128
# rows at starts 0, 5 and 300
CHUNK_CASES = [(c, start) for c in (1, 7, 16, 128) for start in (0, 5, 300)]
# timed at D 128: (pools, C, start, H, Hkv); the first of each kind is its
# JSON row.  A chunk of the serve trace, a partial hit's suffix after the
# chat trace's 992-token system prompt, a one-shot-sized chunk, and the
# serve trace's chunk at chatglm3-6b's 32 query heads over 2 kv heads
CHUNK_TIMED = [("bf16", 128, 0, 32, 32), ("bf16", 128, 300, 32, 32),
               ("bf16", 16, 992, 32, 32), ("bf16", 512, 0, 32, 32),
               ("int8", 128, 0, 32, 32), ("int8", 128, 300, 32, 32),
               # chatglm3-6b's query group of 16
               ("bf16", 128, 0, 32, 2), ("bf16", 128, 300, 32, 2),
               ("int8", 128, 0, 32, 2), ("int8", 128, 300, 32, 2)]


def _quantized(pages):
    """A bf16 pool as the int8 cache holds it: an (int8, float32 scale)
    pair, quantized per row and head."""
    from repro_torch.models.attention import quantize_rows

    return quantize_rows(pages)


def _chunk_inputs(torch, gen, c, h, hkv, d, kv, pps=64, page=16,
                  copies=1):
    """Chunk queries [rows, H, D] (a 7-row chunk in a bucket of 16), pool
    copies of pps + 3 pages (bf16 or int8 pairs) and a block row of pps
    pages in random order."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    rows = 16 if c == 7 else c
    n_pages = pps + 3
    pools = []
    for _ in range(copies):
        kp, vp = randn(n_pages, page, hkv, d), randn(n_pages, page, hkv, d)
        pools.append((_quantized(kp), _quantized(vp)) if kv == "int8"
                     else (kp, vp))
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    return randn(rows, h, d), pools, (perm[:pps] + 1).to(torch.int32)


def _one_shot_of_chunk(torch, q, kp, vp, row, start, c):
    """(q, k, v) of the one-shot run the chunk's first c queries sit in: B=1,
    S = start + c, the keys gathered from the block row (int8 pools:
    dequantized to bf16), the chunk's queries at their positions and
    zeros before them."""
    from repro_torch.models.attention import gather_paged_rows

    n = start + c
    qa = torch.zeros((1, n) + tuple(q.shape[1:]), dtype=torch.bfloat16,
                     device=q.device)
    qa[0, start:] = q[:c]
    k, v = (gather_paged_rows(x, row[None])[:, :n].to(torch.bfloat16)
            .contiguous() for x in (kp, vp))
    return qa, k, v


def _chunk_key_fault(torch, q, kp, vp, row, start, c, got, kv, page=16):
    """The key one past query i's position (i = c // 2) overwritten in the
    pool: query i's output must keep its bits, query i + 1's must move."""
    from repro_torch.kernels.decode_attention.ops import paged_chunk_attention

    i = c // 2
    t = start + i + 1
    pid, off = int(row[t // page]), t % page
    if kv == "int8":
        bad_k = (kp[0].clone(), kp[1].clone())
        bad_v = (vp[0].clone(), vp[1].clone())
        bad_k[0][pid, off] = 127 - bad_k[0][pid, off].abs()
        bad_v[0][pid, off] = -bad_v[0][pid, off]
    else:
        bad_k, bad_v = kp.clone(), vp.clone()
        bad_k[pid, off] = bad_k[pid, off] * -4 + 1
        bad_v[pid, off] = bad_v[pid, off] * 8
    bad = paged_chunk_attention(q, bad_k, bad_v, row, start, c)
    torch.cuda.synchronize()
    kept = torch.equal(bad[i], got[i])
    moved = not torch.equal(bad[i + 1], got[i + 1])
    log(f"[kernels] planted fault, paged_chunk_attention {kv} start {start} "
        f"C {c}: key {t} (one past query {i}) overwritten: query {i} "
        f"{'unchanged' if kept else 'MOVED'}, query {i + 1} "
        f"{'moved' if moved else 'UNCHANGED'}")
    if not kept or not moved:
        raise AssertionError("paged_chunk_attention attends a key past its "
                             "query's position, or not the one at it")


def _chunk_bound(c, start, h, hkv, d, kv, pps=64):
    """(bytes, operations) the chunk's function needs: q and out once,
    each K/V row up to the last query's position once (int8: codes and
    scales), the block row; 4 D operations a (query, head, key)."""
    n_keys = start + c
    elt = 1 if kv == "int8" else 2
    kv_bytes = 2 * n_keys * hkv * d * elt + (2 * n_keys * hkv * 4
                                             if kv == "int8" else 0)
    pairs = sum(start + i + 1 for i in range(c))
    return 2 * c * h * d * 2 + kv_bytes + pps * 4, 4 * h * d * pairs


def _check_chunk(torch, name, kv, q, kp, vp, row, start, c):
    """The chunk against its plain version (ATTN_TOL), B3's one-shot bits
    (bf16 pools), the same queries in one chunk from 0 (bit for bit) and
    its padding rows (0).  Returns (chunk output, max |err|, worst
    |err|/limit)."""
    from repro_torch.kernels.decode_attention.ops import paged_chunk_attention
    from repro_torch.kernels.decode_attention.ref import (
        paged_chunk_attention_ref)
    from repro_torch.kernels.flash_attention.ops import flash_attention

    tag = f"{name}[D {q.shape[-1]} C {c} start {start}]"
    got = paged_chunk_attention(q, kp, vp, row, start, c)
    pos = start + torch.arange(q.shape[0], device=q.device)
    ref = paged_chunk_attention_ref(q[None], kp, vp, row[None], pos[None])[0]
    qa, ka, va = _one_shot_of_chunk(torch, q, kp, vp, row, start, c)
    from_0 = paged_chunk_attention(qa[0], kp, vp, row, 0, start + c)[start:]
    b3 = flash_attention(qa, ka, va)[0, start:] if kv == "bf16" else None
    torch.cuda.synchronize()
    err, used = _check_close(torch, tag, got[:c], ref[:c])
    if b3 is not None and not torch.equal(got[:c], b3):
        bad = int((got[:c] != b3).any(-1).any(-1).sum())
        raise AssertionError(f"{tag}: {bad} of {c} queries differ from B3's "
                             f"one-shot bits")
    if not torch.equal(got[:c], from_0):
        raise AssertionError(f"{tag}: a query's bits differ between this "
                             f"chunk and one chunk from 0")
    if bool(got[c:].float().any()):
        raise AssertionError(f"{tag}: a padding row is not 0")
    return got, err, used


def _kernels_chunk(torch, results: dict) -> None:
    """The paged chunk kernel (bf16 and int8 pools) at D 128 and 112 and
    every CHUNK_CASES shape: within ATTN_TOL of its plain version (the JAX
    float32 formula), every valid query bit-equal to B3's one-shot output
    (bf16 pools) and to the same query in one chunk from 0, padding rows
    0; a planted key fault; timed at CHUNK_TIMED beside SDPA over the
    gathered block row with a boolean mask and B3 over the one-shot run up
    to the chunk's end."""
    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(19)
    h = hkv = 32
    for kv in ("bf16", "int8"):
        name = "paged_chunk_attention" + ("_int8" if kv == "int8" else "")
        res = results[name]
        res["max_abs_err"] = 0.0
        for d in (128, 112):
            worst = 0.0
            for c, start in CHUNK_CASES:
                q, pools, row = _chunk_inputs(torch, gen, c, h, hkv, d, kv)
                kp, vp = pools[0]
                got, err, used = _check_chunk(torch, name, kv, q, kp, vp,
                                              row, start, c)
                worst = max(worst, used)
                res["max_abs_err"] = max(res["max_abs_err"], err)
                if d == 128 and c == 16 and start == 5:
                    _chunk_key_fault(torch, q, kp, vp, row, start, c, got, kv)
            log(f"[kernels] {name} D={d}, chunks of 1, 7 (in 16), 16 and 128 "
                f"rows at starts 0, 5 and 300: "
                + ("every valid query bit-equal to B3's one-shot output, "
                   if kv == "bf16" else "")
                + f"every query bit-equal in one chunk from 0, padding rows "
                f"0, within {ATTN_TOL} of the plain version (worst "
                f"|err|/limit {worst:.3f})")
        json_done = False
        for tkv, c, start, th, thkv in CHUNK_TIMED:
            if tkv != kv:
                continue
            row = _time_chunk(torch, gen, res, name, kv, c, start, th, thkv)
            if not json_done:
                json_done = True
                res.update(row)


def _time_chunk(torch, gen, res, name, kv, c, start, h, hkv, d=128) -> dict:
    """The chunk kernel at one CHUNK_TIMED shape: checked as
    ``_check_chunk`` does, then timed beside its plain version, SDPA over
    the gathered block row with a boolean causal mask, B3 over the one-shot
    run up to the chunk's end, and its bound.  Returns the JSON row's
    numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import paged_chunk_attention
    from repro_torch.kernels.decode_attention.ref import (
        paged_chunk_attention_ref)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.attention import gather_paged_rows

    q, pools, row = _chunk_inputs(torch, gen, c, h, hkv, d, kv, copies=3)
    kp, vp = pools[0]
    _got, err, used = _check_chunk(torch, name, kv, q, kp, vp, row, start, c)
    res["max_abs_err"] = max(res["max_abs_err"], err)
    pos = start + torch.arange(q.shape[0], device=q.device)
    ms = time_ms(torch, lambda i: paged_chunk_attention(
        q, pools[i][0], pools[i][1], row, start, c), 3)
    dev_ms = profiled_ms(torch, lambda i: paged_chunk_attention(
        q, pools[i][0], pools[i][1], row, start, c),
        (KERNEL_NAMES[name],), 3)
    plain = time_ms(torch, lambda i: paged_chunk_attention_ref(
        q[None], pools[i][0], pools[i][1], row[None], pos[None]), 3)
    # SDPA over the block row gathered (int8: dequantized) to bf16
    # beforehand, with a boolean causal mask from start
    kd = [gather_paged_rows(p[0], row[None]).to(torch.bfloat16)
          .transpose(1, 2).contiguous() for p in pools]
    vd = [gather_paged_rows(p[1], row[None]).to(torch.bfloat16)
          .transpose(1, 2).contiguous() for p in pools]
    mask = (torch.arange(kd[0].shape[2], device=q.device)[None]
            <= pos[:, None])[None, None]
    q4 = q[None].transpose(1, 2)
    gqa = {"enable_gqa": True} if h != hkv else {}
    lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, kd[i], vd[i], attn_mask=mask, **gqa), 3)
    lib_dev = profiled_ms(
        torch, lambda i: F.scaled_dot_product_attention(
            q4, kd[i], vd[i], attn_mask=mask, **gqa), None, 3)
    # B3 over the one-shot run up to the chunk's end (B 1, S start + C):
    # what prefilling the prompt so far in one shot costs
    one = [_one_shot_of_chunk(torch, q, p[0], p[1], row, start, c)
           for p in pools]
    b3 = time_ms(torch, lambda i: flash_attention(*one[i]), 3)
    b3_dev = profiled_ms(torch, lambda i: flash_attention(*one[i]),
                         ("flash_attention",), 3)
    b_bytes, b_ops = _chunk_bound(c, start, h, hkv, d, kv)
    b_ms, b_by = bound(b_bytes, b_ops, "bf16")
    log(f"[kernels] {name} C={c} start={start} H={h} Hkv={hkv} D={d}: "
        f"{ms:.4f} ms (device time {dev_ms:.4f} ms, "
        f"{b_ops / dev_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * b_ms / dev_ms:.1f}% of the bound), plain "
        f"{plain:.4f} ms, SDPA on the gathered block row "
        f"{lib:.4f} ms (device {lib_dev:.4f} ms), B3 one-shot S "
        f"{start + c} {b3:.4f} ms (device {b3_dev:.4f} ms), bound "
        f"{b_ms:.4f} ms ({b_by}); "
        + ("B3's bits and " if kv == "bf16" else "")
        + f"the plain version's tolerance held (worst |err|/limit "
        f"{used:.3f})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
                shape=f"C={c} start={start} H={h} D={d}")


# ---------------------------------------------------------------------------
# the grouped GEMM (the moe family's ragged_dot)
# ---------------------------------------------------------------------------

# qwen2-moe-a2.7b: 60 routed experts padded to 64, top-4, d_model 2048,
# moe_d_ff 1408; up / gate [E, 2048, 1408], down [E, 1408, 2048]
MOE_E, MOE_D, MOE_F, MOE_TOPK, MOE_REAL = 64, 2048, 1408, 4, 60
# the kernel against its plain version: both accumulate in float32 and
# round once to bf16; the float32 sums run in another order, so the two
# round to the same or adjacent bf16 values, plus float32 summation noise
# of the sum of |products| on outputs near 0
GG_ULPS, GG_REL = 2, 1e-5
GG_TOL = f"{GG_ULPS} bf16 steps of |plain| + {GG_REL} (|x| @ |W|)"


def _routing_sizes(torch, tokens: int, seed: int):
    """int32 group sizes [64] of a real routing: ``tokens`` random tokens
    through a random float32 router over the 60 real experts, top-4 by a
    stable descending sort, the 4 padded experts empty."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((tokens, MOE_D), generator=gen, device="cuda")
    w = torch.randn((MOE_D, MOE_E), generator=gen, device="cuda") \
        * MOE_D ** -0.5
    logits = (x @ w).masked_fill(
        torch.arange(MOE_E, device="cuda") >= MOE_REAL, -1e30)
    top = torch.sort(logits, dim=-1, descending=True,
                     stable=True)[1][:, :MOE_TOPK]
    return torch.zeros(MOE_E, dtype=torch.int32, device="cuda").scatter_add_(
        0, top.reshape(-1), torch.ones(tokens * MOE_TOPK, dtype=torch.int32,
                                       device="cuda"))


def _grouped_limit(torch, x, w, sizes, ref):
    """(|err| limit per output, rows covered): GG_ULPS bf16 steps of |ref|
    plus GG_REL (|x| @ |W_e(r)|), the latter by a grouped product of |x|
    and |W| in float32 (the plain version's own loop)."""
    from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref

    mag = grouped_gemm_ref(x.abs().float(), w.abs().float(), sizes)
    return GG_ULPS * _bf16_step(torch, ref) + GG_REL * mag, int(sizes.sum())


def _check_grouped(torch, name, got, ref, limit, rows) -> tuple[float, float]:
    """(max |err|, worst |err| / limit) over the covered rows; rows past
    them must be 0; raises beyond the limit."""
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    if bool(got[rows:].any()):
        raise AssertionError(f"{name}: rows past the groups' sum not 0")
    err = (got.float() - ref.float()).abs()[:rows]
    lim = limit[:rows]
    bad = int((err > lim).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} outputs beyond {GG_TOL}, max "
                             f"|err| {err.max().item():.3e}")
    return err.max().item(), (err / lim).max().item()


def _grouped_library(torch, x, w, sizes, ref, limit, rows):
    """One PyTorch call computing the same grouped product, as the
    yardstick: ``torch._grouped_mm`` (x, W with K contiguous, the int32
    end offsets) where this torch has it and it agrees with the plain
    version within GG_TOL; otherwise a per-expert ``torch.matmul`` loop
    (the group sizes read on the host).  Returns (fn, what it is)."""
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    why = "torch._grouped_mm missing"
    fn = getattr(torch, "_grouped_mm", None)
    if fn is not None:
        for wl in (w, w.transpose(-2, -1).contiguous().transpose(-2, -1)):
            try:
                out = fn(x, wl, offs=offs, out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
            except (RuntimeError, TypeError, ValueError) as e:
                why = f"torch._grouped_mm refused: {str(e).splitlines()[0]}"
                continue
            err = (out.float() - ref.float()).abs()[:rows]
            if bool((err <= limit[:rows]).all()):
                return (lambda: fn(x, wl, offs=offs,
                                   out_dtype=torch.bfloat16),
                        "torch._grouped_mm")
            why = "torch._grouped_mm disagreed with the plain version"
    ends = [0] + offs.tolist()
    spans = [(e, ends[e], ends[e + 1]) for e in range(len(ends) - 1)
             if ends[e + 1] > ends[e]]

    def loop():
        return torch.cat([x[a:b] @ w[e] for e, a, b in spans])
    return loop, f"a per-expert torch.matmul loop ({why})"


# group sizes around the kernel's 64-row warpgroup and 128-row CTA tiles
GG_EDGES = (63, 64, 65, 127, 128, 129)


def _grouped_invariance(torch, w) -> None:
    """A row's bits at one shape: alone (a group of 1) and inside groups
    of 2, 7, 16, the tile edges, 136 and 8,192 rows, first, in the middle
    and last, with other experts' rows before and after: the same every
    time."""
    from repro_torch.kernels.grouped_gemm.ops import grouped_gemm

    k, n = w.shape[1], w.shape[2]
    gen = torch.Generator(device="cuda").manual_seed(31)
    v = torch.randn((k,), generator=gen, device="cuda").to(torch.bfloat16)

    def row_of(size, place):
        sizes = torch.zeros(MOE_E, dtype=torch.int32)
        sizes[3], sizes[11], sizes[50] = 37, size, 5
        x = torch.randn((int(sizes.sum()), k), generator=gen,
                        device="cuda").to(torch.bfloat16)
        at = 37 + {"first": 0, "middle": size // 2, "last": size - 1}[place]
        x[at] = v
        return grouped_gemm(x, w, sizes.to("cuda"))[at]

    alone = row_of(1, "first")
    checked = 0
    for size in (2, 7, 16) + GG_EDGES + (136, 8192):
        for place in ("first", "middle", "last"):
            if not torch.equal(row_of(size, place), alone):
                raise AssertionError(f"grouped_gemm K={k} N={n}: a row's "
                                     f"bits in a group of {size} ({place}) "
                                     f"differ from the row alone")
            checked += 1
    log(f"[kernels] grouped_gemm row invariance K={k} N={n}: a row's {n} "
        f"outputs bit-equal alone and in {checked} placements (groups of 2, "
        f"7, 16, {', '.join(map(str, GG_EDGES))}, 136 and 8,192 rows; "
        f"first, middle, last; experts 3 and 50 loaded around it)")


def _kernels_grouped(torch, results: dict) -> None:
    """The grouped GEMM at qwen2-moe-a2.7b's up (2048 -> 1408) and down
    (1408 -> 2048) shapes over 64 experts: decode (16 rows on 16 experts,
    16 rows on one), prefill (8,192 rows with a real routing's group
    sizes), a skew (8,192 rows on one expert, 63 empty) and the tile
    edges (groups of 63 to 129 rows, an empty expert between two full
    tiles, rows past the groups' sum), each against its plain version
    within GG_TOL, rows past the groups' sum 0; a row's bits invariant to
    its group at both shapes; a planted fault (one row's group offset off
    by one) must fail; the first four timed beside their bound, the plain
    version and a library call.  The JSON row is the decode up shape."""
    from repro_torch.kernels.grouped_gemm.ops import grouped_gemm
    from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref

    gen = torch.Generator(device="cuda").manual_seed(29)
    ws = {(k, n): (torch.randn((MOE_E, k, n), generator=gen, device="cuda")
                   * k ** -0.5).to(torch.bfloat16)
          for k, n in ((MOE_D, MOE_F), (MOE_F, MOE_D))}
    spread = torch.zeros(MOE_E, dtype=torch.int32, device="cuda")
    spread[torch.randperm(MOE_REAL, generator=torch.Generator()
                          .manual_seed(3))[:16].to("cuda")] = 1
    one = torch.zeros(MOE_E, dtype=torch.int32, device="cuda")
    one[17] = 16
    skew = torch.zeros(MOE_E, dtype=torch.int32, device="cuda")
    skew[42] = 8192
    # checked, not timed: the tile edges around an empty expert between
    # two full 128-row tiles, and 37 rows past the groups' sum (R 869,
    # not a multiple of the row tile)
    edges = torch.zeros(MOE_E, dtype=torch.int32, device="cuda")
    edges[4:4 + len(GG_EDGES)] = torch.tensor(GG_EDGES, dtype=torch.int32)
    edges[20], edges[21], edges[22] = 128, 0, 128
    cases = [("decode, 16 rows on 16 experts", spread, 0),
             ("decode, 16 rows on one expert", one, 0),
             ("prefill, 8,192 rows, a real routing", _routing_sizes(
                 torch, 2048, 5), 0),
             ("skew, 8,192 rows on one expert", skew, 0),
             ("tile edges, an empty expert between two full ones, 37 rows "
              "past the sum", edges, 37)]
    res = results["grouped_gemm"]
    res["max_abs_err"] = 0.0
    for (k, n), w in ws.items():
        for tag, sizes, tail in cases:
            rows = int(sizes.sum()) + tail
            x = torch.randn((rows, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            got = grouped_gemm(x, w, sizes)
            ref = grouped_gemm_ref(x, w, sizes)
            torch.cuda.synchronize()
            limit, covered = _grouped_limit(torch, x, w, sizes, ref)
            err, used = _check_grouped(torch, "grouped_gemm", got, ref,
                                       limit, covered)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            nonempty = int((sizes > 0).sum())
            line = (f"[kernels] grouped_gemm {tag} K={k} N={n} ({nonempty} "
                    f"of {MOE_E} experts non-empty): max|err| {err:.3e} "
                    f"(worst |err|/limit {used:.3f}; tol {GG_TOL})")
            if tag.startswith("decode, 16 rows on 16") and k == MOE_D:
                # planted fault: the first non-empty expert's last row
                # handed to the next expert, as an offset off by one would
                bad_sizes = sizes.clone()
                e0 = int(torch.nonzero(sizes)[0])
                bad_sizes[e0] -= 1
                bad_sizes[e0 + 1] += 1
                wrong = grouped_gemm(x, w, bad_sizes)
                caught = int(((wrong.float() - ref.float()).abs()
                              > limit)[:covered].sum())
                log(f"[kernels] planted fault, grouped_gemm with expert "
                    f"{e0}'s group offset off by one: {caught} of "
                    f"{covered * n} outputs beyond {GG_TOL}")
                if caught == 0:
                    raise AssertionError("planted fault (a group offset off "
                                         "by one) passes the grouped_gemm "
                                         "check")
            if tail:
                log(line)
                continue
            ms = time_ms(torch, lambda i: grouped_gemm(x, w, sizes))
            dev_ms = profiled_ms(torch, lambda i: grouped_gemm(x, w, sizes),
                                 ("grouped_gemm_kernel",))
            plain = time_ms(torch, lambda i: grouped_gemm_ref(x, w, sizes),
                            iters=5)
            lib_fn, lib_what = _grouped_library(torch, x, w, sizes, ref,
                                                limit, covered)
            lib = time_ms(torch, lambda i: lib_fn())
            lib_dev = profiled_ms(torch, lambda i: lib_fn(), None)
            # each input read once (x, the non-empty experts' weights, the
            # sizes), the output written once; 2 R K N operations on the
            # bf16 tensor cores
            bytes_moved = (rows * k * 2 + nonempty * k * n * 2 + MOE_E * 4
                           + rows * n * 2)
            ops = 2 * rows * k * n
            b_ms, b_by = bound(bytes_moved, ops, "bf16")
            if not res.get("shape"):
                res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                           library_ms=lib, library_device_ms=lib_dev,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"R={rows} K={k} N={n} E={MOE_E} "
                                 f"({nonempty} non-empty)")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms, "
                     f"{100 * b_ms / dev_ms:.1f}% of the bound, "
                     f"{ops / dev_ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} "
                     f"ms, library {lib:.4f} ms (device {lib_dev:.4f} ms; "
                     f"{lib_what}), bound {b_ms:.4f} ms ({b_by}: "
                     f"{bytes_moved / 1e6:.1f} MB at 3.35 TB/s, "
                     f"{ops / 1e9:.2f} GFLOP at 989 TFLOP/s)")
            log(line)
    for w in ws.values():
        _grouped_invariance(torch, w)


# ---------------------------------------------------------------------------
# the paged MLA decode kernel (the mla_moe family's decode attention)
# ---------------------------------------------------------------------------

# the kernel against its plain version: both float32 (a float32 context,
# no bf16 rounding), the sums in other orders (the splits' partials, the
# lanes' shuffles), so the limit is a float32 relative noise of the
# context's own scale, max|ckv| over the slot's rows
MLA_RTOL = 1e-5
MLA_TOL = f"{MLA_RTOL} x max|ckv|"
# (tag, lengths); deepseek-v2-lite-16b: B 4, H 16, R 512, Dr 64, page 16,
# a 1,024-token capacity (max_seq 1024)
MLA_CASES = [("1024/545/17/0", [1024, 545, 17, 0]),
             ("serve trace", [403, 331, 275, 439]),
             ("split edges", [1, 63, 64, 65])]


def _mla_inputs(torch, gen, lens, kv, h=16, r=512, dr=64, page=16,
                pps=64):
    """float32 queries (scores to ~+-10), bf16 or int8 (data, scale) pools
    of seeded rows, a shuffled block table and int32 lengths, on the
    card."""
    from repro_torch.models.attention import quantize_rows

    dev = torch.device("cuda")
    b = len(lens)
    n = b * pps + 1
    ckv = torch.randn((n, page, r), generator=gen, device=dev)
    kr = torch.randn((n, page, dr), generator=gen, device=dev)
    pools = ((quantize_rows(ckv), quantize_rows(kr)) if kv == "int8"
             else (ckv.to(torch.bfloat16), kr.to(torch.bfloat16)))
    perm = torch.randperm(n - 1, generator=torch.Generator().manual_seed(
        len(lens) + sum(lens)))[:b * pps] + 1
    block = perm.reshape(b, pps).to(torch.int32).to(dev)
    q_c = torch.randn((b, h, r), generator=gen, device=dev) * (0.6 / r ** .5)
    q_r = torch.randn((b, h, dr), generator=gen, device=dev) * (0.6 / dr ** .5)
    return (q_c, q_r, *pools, block,
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _mla_check(torch, name, got, ref, lengths, mag) -> float:
    """|got - ref| <= MLA_TOL on the live lanes, a length-0 lane 0;
    returns the max |err|."""
    live = lengths > 0
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - ref).abs()[live]
    if not bool((err <= MLA_RTOL * mag).all()):
        raise AssertionError(f"{name}: {int((err > MLA_RTOL * mag).sum())} "
                             f"outputs above {MLA_TOL}, max |err| "
                             f"{err.max().item():.3e}")
    if bool(got[~live].any()):
        raise AssertionError(f"{name}: a length-0 lane is not 0")
    return err.max().item()


def _kernels_mla(torch, results: dict) -> None:
    """The MLA decode kernel against its plain version (JAX's formula) at
    deepseek-v2-lite-16b's shapes over bf16 and int8 pools: the lengths
    1024 / 545 / 17 / 0, the serve trace's and the split edges; the
    planted faults (lane 0 one page short, every lane's last split
    dropped) must fail; a slot's bits alone, in its batch and under a
    wider table; timed beside its bound (float32 operations or bytes; and
    the bound of its instruction mix, 3x the operations on the bf16 tensor
    cores), SDPA over the gathered, dequantized float32 rows with a length
    mask, and the PR 27 kernel it replaced, in turns (new, PR 27, PR 27,
    new) in this call."""
    import torch.nn.functional as F

    from repro_torch.kernels import diag_mla
    from repro_torch.kernels.mla_decode_attention.ops import (
        mla_decode_attention)
    from repro_torch.kernels.mla_decode_attention.ref import (
        SPLIT, mla_decode_attention_ref)
    from repro_torch.models.attention import gather_paged_rows

    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    scale = 192 ** -0.5
    h, r, dr, page = 16, 512, 64, 16
    for kv in ("bf16", "int8"):
        name = "mla_decode_attention" + ("_int8" if kv == "int8" else "")
        for tag, lens in MLA_CASES:
            q_c, q_r, ckv, kr, block, lengths = _mla_inputs(torch, gen, lens,
                                                            kv)
            got = mla_decode_attention(q_c, q_r, ckv, kr, block, lengths,
                                       scale)
            torch.cuda.synchronize()
            ref = mla_decode_attention_ref(q_c, q_r, ckv, kr, block, lengths,
                                           scale)
            ckv_g = gather_paged_rows(ckv, block).float()
            kr_g = gather_paged_rows(kr, block).float()
            mag = ckv_g.abs().max()
            err = _mla_check(torch, f"{name}[{tag}]", got, ref, lengths, mag)
            res = results[name]
            res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
            wide = torch.cat([block, block[:, :8]], 1).contiguous()
            alone = all(torch.equal(mla_decode_attention(
                q_c[i:i + 1].contiguous(), q_r[i:i + 1].contiguous(), ckv,
                kr, block[i:i + 1].contiguous(),
                lengths[i:i + 1].contiguous(), scale)[0], got[i])
                for i in range(len(lens)))
            wider = torch.equal(mla_decode_attention(
                q_c, q_r, ckv, kr, wide, lengths, scale), got)
            if not (alone and wider):
                raise AssertionError(f"{name}[{tag}]: a slot's bits depend "
                                     f"on its batch (alone {alone}) or the "
                                     f"table's width ({wider})")
            line = (f"[kernels] {name} {tag} B={len(lens)} H={h} R={r} "
                    f"Dr={dr} lens={lens}: max|err| {err:.3e} (tol {MLA_TOL}"
                    f" = {MLA_RTOL * mag.item():.3e}); a slot's bits alone, "
                    f"in its batch and under a table 8 pages wider: equal")
            if tag != "split edges":
                # the faults, computed by the plain version: lane 0 one page
                # short; every lane cut back to the start of its last split
                short = lengths.clone()
                short[0] = max(int(short[0]) - page, 0)
                cut = torch.where(lengths > 0, (lengths - 1) // SPLIT * SPLIT,
                                  lengths)
                for fault, bad_len in (("lane 0 one page short", short),
                                       ("every lane's last split dropped",
                                        cut)):
                    bad = mla_decode_attention_ref(q_c, q_r, ckv, kr, block,
                                                   bad_len, scale)
                    bad = torch.where((bad_len > 0)[:, None, None], bad, 0.0)
                    ferr = (bad - ref).abs()[lengths > 0]
                    caught = int((ferr > MLA_RTOL * mag).sum())
                    log(f"[kernels] planted fault, {name} {tag}, {fault}: "
                        f"{caught} of {ferr.numel()} outputs above "
                        f"{MLA_TOL}, max|err| {ferr.max().item():.3e}")
                    if caught == 0:
                        raise AssertionError(f"planted fault ({fault}) "
                                             f"passes the {name} check")
                old = _MLA_PR27[0] if _MLA_PR27 else diag_mla.load()

                def new_fn(i):
                    return mla_decode_attention(q_c, q_r, ckv, kr, block,
                                                lengths, scale)

                def old_fn(i):
                    return diag_mla.pr27(old, q_c, q_r, ckv, kr, block,
                                         lengths, scale)

                old_err = _mla_check(torch, f"PR 27 {name}[{tag}]",
                                     old_fn(0), ref, lengths, mag)
                turns = {"new": [], "pr27": []}
                for k in ("new", "pr27", "pr27", "new"):
                    turns[k].append(time_ms(torch, new_fn if k == "new"
                                            else old_fn))
                ms = statistics.mean(turns["new"])
                old_ms = statistics.mean(turns["pr27"])
                dev_ms = profiled_ms(torch, new_fn,
                                     ("mla_decode_attention_kernel",))
                old_dev = profiled_ms(torch, old_fn, diag_mla.PR27_KERNELS)
                plain = time_ms(torch, lambda i: mla_decode_attention_ref(
                    q_c, q_r, ckv, kr, block, lengths, scale))
                # SDPA on the gathered, dequantized float32 rows: q = q_c |
                # q_rope, one kv head of keys ckv | krope and values ckv
                qs = torch.cat([q_c, q_r], -1)[:, :, None]
                ks = torch.cat([ckv_g, kr_g], -1)[:, None]
                vs = ckv_g[:, None]
                mask = (torch.arange(ks.shape[2], device="cuda")[None, :]
                        < lengths[:, None])[:, None, None]

                def sdpa(i):
                    return F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=mask, scale=scale,
                        enable_gqa=True)

                lib = time_ms(torch, sdpa)
                lib_dev = profiled_ms(torch, sdpa)
                keys = int(lengths.clamp(max=block.shape[1] * page).sum())
                elem = 1 if kv == "int8" else 2
                bytes_moved = (keys * ((r + dr) * elem
                                       + (8 if kv == "int8" else 0))
                               + len(lens) * h * (2 * r + dr) * 4
                               + len(lens) * 4)
                ops = keys * 2 * h * (2 * r + dr)
                # the kernel's instruction mix: each float32 product as
                # three bf16 products on the tensor cores; the float32
                # CUDA-core bound printed beside it
                b_ms, b_by = bound(bytes_moved, 3 * ops, "bf16")
                f32_ms, f32_by = bound(bytes_moved, ops, "f32")
                if tag == "1024/545/17/0":
                    res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                               library_ms=lib, library_device_ms=lib_dev,
                               bound_ms=b_ms, bound_by=b_by,
                               shape=f"B={len(lens)} H={h} R={r} Dr={dr} "
                                     f"lens={lens}")
                line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms; "
                         f"event turns {turns['new'][0]:.4f} / "
                         f"{turns['new'][1]:.4f}), the PR 27 kernel in "
                         f"turns {old_ms:.4f} ms (device {old_dev:.4f} ms; "
                         f"max|err| {old_err:.3e}), plain {plain:.4f} ms, "
                         f"SDPA on the gathered float32 rows {lib:.4f} ms "
                         f"(device {lib_dev:.4f} ms), bound {b_ms:.4f} ms "
                         f"({b_by}: {bytes_moved / 1e6:.2f} MB, 3 x "
                         f"{ops / 1e6:.1f} MFLOP bf16); on the float32 "
                         f"CUDA cores {f32_ms:.4f} ms ({f32_by})")
            log(line)


def _kernels_b1_int8(torch, results: dict) -> None:
    """B1 over int8 pools: against its plain version (which dequantizes as
    the kernel does) within ATTN_TOL at the llama2-7b and zamba2-7b
    batches and the serve trace's lengths, length-0 lanes 0, the planted
    faults and batch invariance; timed beside B1's bf16 row and SDPA over
    the dequantized, gathered cache."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref)
    from repro_torch.models.attention import gather_paged_rows

    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(20)
    dev = torch.device("cuda")
    res = results["paged_decode_attention_int8"]
    res["max_abs_err"] = 0.0
    page, max_seq = 16, 1024
    edges = [0, 1, 63, 64, 65, 1024]
    for tag, b, h, hkv, d, lens in [
            ("llama2-7b", 4, 32, 32, 128, [1024, 545, 17, 0]),
            ("zamba2-7b", 4, 32, 32, 112, [1024, 545, 17, 0]),
            ("smollm-360m", 4, 15, 5, 64, [700, 64, 1, 0]),
            ("serve group 2", 4, 32, 32, 128, [403, 331, 275, 439]),
            ("chatglm3-6b", 4, 32, 2, 128, [1024, 545, 17, 0]),
            ("command-r-plus-104b", 4, 96, 8, 128, [1024, 545, 17, 0]),
            ("split edges, group 16", 6, 32, 2, 128, edges),
            ("split edges, group 12", 6, 96, 8, 128, edges),
            ("qwen2-vl-72b serve group 2", 4, 64, 8, 128,
             [659, 587, 531, 695])]:
        pps = max_seq // page
        n_pages = b * pps + 1
        timed = tag in ("llama2-7b", "serve group 2", "chatglm3-6b",
                        "command-r-plus-104b")
        pools = [tuple(_quantized(torch.randn(
            (n_pages, page, hkv, d), generator=gen, device=dev).to(
                torch.bfloat16)) for _ in range(2))
            for _ in range(3 if timed else 1)]
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
        block = (perm[:b * pps] + 1).reshape(b, pps).to(torch.int32)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(
            torch.bfloat16)
        kp, vp = pools[0]
        got = paged_decode_attention(q, kp, vp, block, lengths)
        ref = paged_decode_attention_ref(q, kp, vp, block, lengths)
        torch.cuda.synchronize()
        live = lengths > 0
        err, used = _check_close(torch, f"paged_decode_attention_int8[{tag}]",
                                 got[live], ref[live])
        if bool(got[~live].float().any()):
            raise AssertionError("int8: a length-0 lane is not 0")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        line = (f"[kernels] paged_decode_attention_int8 {tag} B={b} H={h} "
                f"Hkv={hkv} D={d} lens={lens}: max|err| {err:.3e} (worst "
                f"|err|/limit {used:.3f}; tol {ATTN_TOL})")
        if tag in ("llama2-7b", "zamba2-7b", "chatglm3-6b",
                   "qwen2-vl-72b serve group 2"):
            _planted_faults(torch, q, kp, vp, block, lengths, ref, page)
            _b1_batch_invariance(torch, q, kp, vp, block, lengths, got)
        if timed:
            ms = time_ms(torch, lambda i: paged_decode_attention(
                q, pools[i][0], pools[i][1], block, lengths), 3)
            dev_ms = profiled_ms(torch, lambda i: paged_decode_attention(
                q, pools[i][0], pools[i][1], block, lengths),
                (KERNEL_NAMES["paged_decode_attention_int8"],), 3)
            plain = time_ms(torch, lambda i: paged_decode_attention_ref(
                q, pools[i][0], pools[i][1], block, lengths), 3)
            kd = [gather_paged_rows(p[0], block).to(torch.bfloat16)
                  .transpose(1, 2).contiguous() for p in pools]
            vd = [gather_paged_rows(p[1], block).to(torch.bfloat16)
                  .transpose(1, 2).contiguous() for p in pools]
            mask = (torch.arange(max_seq, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            gqa = {"enable_gqa": True} if h != hkv else {}
            lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                q4, kd[i], vd[i], attn_mask=mask, **gqa), 3)
            lib_dev = profiled_ms(
                torch, lambda i: F.scaled_dot_product_attention(
                    q4, kd[i], vd[i], attn_mask=mask, **gqa), None, 3)
            n_tok = sum(lens)
            kv_bytes = 2 * n_tok * hkv * (d + 4)   # codes and scales
            bytes_moved = 2 * b * h * d * 2 + kv_bytes + block.numel() * 4 \
                + b * 4
            b_ms, b_by = bound(bytes_moved, 4 * n_tok * h * d, "bf16")
            if tag == "llama2-7b":
                res.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                           library_ms=lib, library_device_ms=lib_dev,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"B={b} H={h} D={d} lens={lens}")
            line += (f" | {ms:.4f} ms (device time {dev_ms:.4f} ms, K/V "
                     f"{kv_bytes / dev_ms / 1e6:.0f} GB/s), plain "
                     f"{plain:.4f} ms, SDPA on the dequantized gathered "
                     f"cache {lib:.4f} ms (device {lib_dev:.4f} ms), bound "
                     f"{b_ms:.4f} ms ({b_by})")
        log(line)


def _prefill_extras(torch, cfg, rows: int, dev="cuda") -> tuple[dict, int]:
    """(the engine's prefill extras for ``rows`` rows, the cache rows they
    add to each): the vlm family's zero vision embeddings (256 rows at
    qwen2-vl-72b), the audio family's zero frames, as the engine feeds
    them."""
    from repro_torch.serving.core import _batch_extras

    extra = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    return _batch_extras(cfg, rows, torch.device(dev)), extra


def _tree_to(torch, tree, dev, f32=False):
    """A param tree on ``dev``, its bf16 leaves in float32 with ``f32``."""
    if isinstance(tree, dict):
        return {k: _tree_to(torch, v, dev, f32) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(torch, v, dev, f32) for v in tree]
    if tree is None:
        return None
    if f32 and tree.dtype == torch.bfloat16:
        tree = tree.float()
    return tree.to(dev)


def _to_runs(torch, params_cpu, params_cuda=None) -> dict:
    """The same W8A8 weights three ways: card bf16 (kernels; copied from
    ``params_cpu`` unless given), CPU bf16 (plain versions), CPU float32
    (plain versions, the yardstick)."""
    if params_cuda is None:
        params_cuda = _tree_to(torch, params_cpu, "cuda")
    return {"cpu": (params_cpu, "cpu", torch.bfloat16),
            "cuda": (params_cuda, "cuda", torch.bfloat16),
            "f32": (_tree_to(torch, params_cpu, "cpu", f32=True), "cpu",
                    torch.float32)}


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
                n_req: int = 8, max_new: int = 32, required: tuple = (),
                chunk_prefill: int = 0, kv_dtype: str = "bf16",
                serving: tuple = SERVING_KERNELS,
                layers: int = 0) -> tuple[dict, object]:
    """``arch`` at full width, ``quant``, through launch/serve.py's
    build_client: 4 slots, max_seq 1024, page 16, ``n_req`` greedy requests
    with 64-512-token prompts and ``max_new`` new tokens each
    (``chunk_prefill``: the chunk budget; ``kv_dtype``: the page pools).
    Every launch counter is zeroed before the run and read after; the
    kernels the phase owns (COUNTED_IN), ``serving`` and ``required`` must
    have launched; ``layers``: the configuration cut to its first
    ``layers`` layers and built so (the same draws for those layers as the
    whole model's, ``build_params``), for a path whose gates hold at any
    depth or a model the card cannot hold whole.  Returns the counts and
    the client."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import build_client
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    build = (dataclasses.replace(get_arch(arch), n_layers=layers) if layers
             else arch)
    cfg, client = build_client(build, reduced=False, quant=quant,
                               max_batch=4, max_seq=1024, seed=0,
                               chunk_prefill=chunk_prefill,
                               kv_dtype=kv_dtype, device="cuda")
    if layers:
        log(f"[{tag}] {arch}'s first {layers} of "
            f"{get_arch(arch).n_layers} layers at full width")
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
    # reference for the engine's first token of that request: in chunks of
    # the budget where the engine chunks it
    ref_cache = M.init_paged_cache(cfg, 1, 1024, device="cuda",
                                   kv_dtype=kv_dtype)
    ref_cache["block"] = torch.arange(1, 65, dtype=torch.int32,
                                      device="cuda")[None]
    p0 = prompts[0]
    if chunk_prefill and len(p0) > chunk_prefill:
        ref_logits = _chunked_logits(torch, core.params, cfg, p0,
                                     chunk_prefill, ref_cache)[None]
    else:
        ex, extra = _prefill_extras(torch, cfg, 1)
        ref_logits, _ = M.prefill_into_slots(
            core.params, cfg, torch.tensor([p0], device="cuda"),
            torch.tensor([len(p0) + extra], device="cuda"), ref_cache,
            torch.tensor([0], device="cuda"), ex)
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
    log(f"[{tag}] decode: {core.graph.replays} CUDA graph replays; the "
        f"first step's warm-up and capture took "
        f"{sum(core.graph.capture_s.values()) * 1e3:.0f} ms of the decode "
        f"wall above on {smi}")
    missing = [k for k, phase in COUNTED_IN.items()
               if phase == tag and counts[k] <= 0 and k not in OFF_PATH]
    missing += [k for k in tuple(serving) + tuple(required)
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
                 ("B4 GeMV", ("w4a16_gemv_",)),
                 ("grouped GEMM", ("grouped_gemm_kernel",)))
DECODE_PARTS = (("B1", ("paged_decode_attention",)),
                ("MLA", ("mla_decode_",)),
                ("B2 GeMV", ("int8_gemv",)), ("B4 GeMV", ("w4a16_gemv_",)),
                ("grouped GEMM", ("grouped_gemm_kernel",)))


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


def phase_profile(torch, client, smi: str, tag: str = "profile"):
    """Where the time of a serve phase's engine (after its run) goes: one
    prefill group (``_prefill_profile``), then torch.profiler over 6 decode
    steps of 4 slots, device kernel time against the host's wall clock.
    Returns the decode window's kernel rows (``_kernel_rows``) and its
    steps."""
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
    host = sum(_host_launches(prof).values()) / steps
    log(f"[{tag}] profile of {steps} decode steps of 4 slots: wall "
        f"{wall * 1e3 / steps:.2f} ms/step (profiled), {launches:.0f} device "
        f"kernels/step from {host:.1f} host launch calls/step, device "
        f"kernels {busy * 1e3 / steps:.2f} ms/step, device busy "
        f"{100 * busy / wall:.1f}% of wall on {smi}")
    log(f"[{tag}] decode step by kernel (mean of {steps} steps): "
        f"{_by_part(rows, DECODE_PARTS, steps)} on {smi}")
    if busy <= 0:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    for dev_us, key, count in rows[:8]:
        log(f"[{tag}]   {dev_us / 1e3 / steps:8.3f} ms/step  "
            f"{count // steps:5d} calls/step  {key[:90]}")
    return rows, steps


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


# host-side CUDA calls that start work on the card, as torch.profiler names
# them: kernel launches (PyTorch's and the C entries'), graph replays and
# copies / fills
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def _host_launches(prof) -> dict[str, int]:
    """Calls of each HOST_LAUNCH_CALLS name the host made in a profiler
    run."""
    out: dict[str, int] = {}
    for ev in prof.key_averages():
        if ev.key in HOST_LAUNCH_CALLS:
            out[ev.key] = out.get(ev.key, 0) + ev.count
    return out


def _sampled(i: int):
    """Odd requests sampled (temperature 0.8, top-k 20, top-p 0.9, a pinned
    seed), even ones greedy."""
    from repro_torch.serving.scheduler import SamplingParams

    return (SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                           seed=300 + i) if i % 2 else None)


def _overlap_streams(torch, client, prompts, max_new, sampling=None,
                     eager=False) -> tuple[list, dict]:
    """Serve ``prompts`` through ``client`` (``sampling(i)`` the params of
    request i, None greedy); every launch counter zeroed before the run and
    read after.  Returns ((tokens, finish reason) per request, a record of
    the run: launch counts, decode steps, dispatches, graph replays)."""
    from repro_torch import kernels
    from repro_torch.serving import graphs

    core = client.router.cores[0]
    steps0, disp0 = core.stats.decode_steps, core.stats.decode_dispatches
    replays0 = core.graph.replays
    handles = [client.submit(p, max_new_tokens=max_new,
                             sampling=sampling(i) if sampling else None)
               for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    if eager:
        with graphs.disabled():
            client.run()
    else:
        client.run()
    torch.cuda.synchronize()
    run = {"counts": kernels.launch_counts(),
           "steps": core.stats.decode_steps - steps0,
           "dispatches": core.stats.decode_dispatches - disp0,
           "replays": core.graph.replays - replays0}
    for h in handles:
        toks = h.request.out_tokens
        if not h.finished or h.finish_reason != "length" \
                or len(toks) != max_new:
            raise AssertionError(f"request {h.rid}: finished={h.finished} "
                                 f"reason={h.finish_reason} n={len(toks)}")
    return [(h.request.out_tokens, h.finish_reason) for h in handles], run


def _check_graph_run(core, run: dict, tag: str, mode: str) -> None:
    """Every decode step of a graph run was one replay, the dispatches a
    step are 1 (overlap) or 2 (sync), and B1 (its int8 variant over int8
    pools) and the decode GeMV(s) were counted through the replays (the
    capture's launches times replays)."""
    want = 1 if core.overlap else 2
    if run["steps"] <= 0 or run["dispatches"] != want * run["steps"]:
        raise AssertionError(f"[{tag}] {mode}: {run['dispatches']} "
                             f"dispatches over {run['steps']} decode steps, "
                             f"expected {want} a step")
    if run["replays"] != run["steps"]:
        raise AssertionError(f"[{tag}] {mode}: {run['replays']} graph "
                             f"replays for {run['steps']} decode steps")
    b1 = ("mla_decode_attention" if core.cfg.family == "mla_moe"
          else "paged_decode_attention")
    if core.kv_dtype == "int8":
        b1 += "_int8"
    for k in (b1, "int8_gemv"):
        per_replay = min(d.get(k, 0) for d in core.graph._deltas.values())
        if per_replay <= 0 or \
                run["counts"][k] < run["replays"] * per_replay:
            raise AssertionError(f"[{tag}] {mode}: {k} launched "
                                 f"{run['counts'][k]} times over "
                                 f"{run['replays']} replays of graphs that "
                                 f"launch it {per_replay} times")


def _decode_wall(torch, client, prompts, max_new, eager=False,
                 sampling=None) -> tuple[float, int]:
    """(wall ms a decode step of 4 slots, steps timed), from a
    synchronized clock around the whole decode loop: the 4 prompts
    admitted (one prefill group and the first step) before the clock
    starts, the loop run to its end (the overlapped loop's last drain
    included).  ``sampling``: every request's SamplingParams (None:
    greedy)."""
    import contextlib

    from repro_torch.serving import graphs

    core = client.router.cores[0]
    for p in prompts:
        client.submit(p, max_new_tokens=max_new, sampling=sampling)
    with graphs.disabled() if eager else contextlib.nullcontext():
        client.pump()
        torch.cuda.synchronize()
        steps0 = core.stats.decode_steps
        t0 = time.perf_counter()
        while client.has_work:
            client.pump()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = core.stats.decode_steps - steps0
    return wall * 1e3 / steps, steps


def _decode_profile(torch, client, prompts, eager=False, steps: int = 6
                    ) -> tuple[float | None, float, float | None]:
    """(device kernel ms, host launch calls, device busy share) a decode
    step, from torch.profiler over ``steps`` steps of 4 slots, the window
    opened and closed by a synchronize (for the overlapped loop: the steps
    dispatched inside it); the busy share is the device kernel time over
    the window's wall time."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import graphs

    for p in prompts:
        client.submit(p, max_new_tokens=steps + 4)
    with graphs.disabled() if eager else contextlib.nullcontext():
        client.pump()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                client.pump()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        client.run()
    dev = _device_ms(prof)
    return (dev / steps if dev is not None else None,
            sum(_host_launches(prof).values()) / steps,
            dev / (wall * 1e3) if dev is not None else None)


def phase_serve_overlap(torch, smi: str) -> None:
    """The one-dispatch decode at full width: llama2-7b W8A8, 4 slots,
    max_seq 1024, page 16, through build_client (synchronous loop) and a
    ServingClient with overlap=True on the same weights.  Gates: 8 greedy
    requests give the same streams synchronous and eager
    (graphs.disabled()), synchronous over replayed graphs, and overlapped;
    8 requests with every second one stochastic (temperature 0.8, top-k 20,
    top-p 0.9, seeds 100 + i) the same synchronous and overlapped; each
    decode step of a graph run is one replay, 2 dispatches a step
    synchronous and 1 overlapped; B1 and the GeMV counted through replays.
    Then the decode wall ms a step three ways, host launch calls and the
    device's busy share.  zamba2-7b W8A8: 4 greedy requests of 16 tokens,
    synchronous and overlapped the same."""
    import gc

    import numpy as np

    from repro_torch.launch.serve import build_client
    from repro_torch.serving.client import ServingClient
    from repro_torch.serving.scheduler import SamplingParams

    tag = "serve_overlap"
    kw = dict(max_batch=4, max_seq=1024, page_size=16, eos_id=-1)
    cfg, sync = build_client("llama2-7b", reduced=False, seed=0,
                             device="cuda", **kw)
    core = sync.router.cores[0]
    olap = ServingClient(cfg, core.params, overlap=True, device="cuda", **kw)
    ocore = olap.router.cores[0]
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in rng.randint(64, 513, size=8)]
    eager, r_eager = _overlap_streams(torch, sync, prompts, 32, eager=True)
    if r_eager["replays"] != 0:
        raise AssertionError("graphs.disabled() replayed a graph")
    graph, r_graph = _overlap_streams(torch, sync, prompts, 32)
    over, r_over = _overlap_streams(torch, olap, prompts, 32)
    _check_graph_run(core, r_graph, tag, "sync graph")
    _check_graph_run(ocore, r_over, tag, "overlap")
    for name, got in (("sync graph", graph), ("overlap", over)):
        if got != eager:
            bad = [i for i, (a, b) in enumerate(zip(eager, got)) if a != b]
            raise AssertionError(f"[{tag}] greedy: {name} differs from "
                                 f"sync eager in requests {bad}")
    log(f"[{tag}] llama2-7b W8A8 greedy, 8 requests x 32 tokens: sync eager, "
        f"sync graph and overlap identical; decode steps {r_eager['steps']} "
        f"/ {r_graph['steps']} / {r_over['steps']}, dispatches a step "
        f"{r_graph['dispatches'] / r_graph['steps']:.0f} (sync) and "
        f"{r_over['dispatches'] / r_over['steps']:.0f} (overlap), graph "
        f"replays {r_graph['replays']} / {r_over['replays']}; launches "
        f"through replays: B1 {r_graph['counts']['paged_decode_attention']}"
        f" / {r_over['counts']['paged_decode_attention']}, GeMV "
        f"{r_graph['counts']['int8_gemv']} / {r_over['counts']['int8_gemv']}"
        f" (eager: {r_eager['counts']['paged_decode_attention']}, "
        f"{r_eager['counts']['int8_gemv']})")

    def stochastic(i):
        return (SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                               seed=100 + i) if i % 2 else None)

    s_sync, r_s = _overlap_streams(torch, sync, prompts, 32, stochastic)
    s_over, r_o = _overlap_streams(torch, olap, prompts, 32, stochastic)
    _check_graph_run(core, r_s, tag, "stochastic sync")
    _check_graph_run(ocore, r_o, tag, "stochastic overlap")
    if s_sync != s_over:
        bad = [i for i, (a, b) in enumerate(zip(s_sync, s_over)) if a != b]
        raise AssertionError(f"[{tag}] stochastic: overlap differs from "
                             f"sync in requests {bad}")
    drawn = sum(a != b for a, b in zip(s_sync[1::2], graph[1::2]))
    log(f"[{tag}] llama2-7b stochastic (every second request temperature "
        f"0.8, top-k 20, top-p 0.9): sync and overlap identical; "
        f"{drawn} of 4 sampled streams differ from their greedy ones; "
        f"overlap graphs captured {sorted(ocore.graph._graphs)}")
    if drawn == 0:
        raise AssertionError("no stochastic stream left its greedy one")

    tprompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
                for n in rng.randint(200, 301, size=4)]
    walls = {"sync eager": _decode_wall(torch, sync, tprompts, 64, True),
             "sync graph": _decode_wall(torch, sync, tprompts, 64),
             "overlap": _decode_wall(torch, olap, tprompts, 64)}
    sampled = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=5)
    wall_s, steps_s = _decode_wall(torch, olap, tprompts, 64,
                                   sampling=sampled)
    prof = {"sync eager": _decode_profile(torch, sync, tprompts, True),
            "sync graph": _decode_profile(torch, sync, tprompts),
            "overlap": _decode_profile(torch, olap, tprompts)}
    for mode, (wall, steps) in walls.items():
        dev, launches, busy_prof = prof[mode]
        if dev is None:
            dev_s = busy = busy_prof = "not measured"
        else:
            dev_s = f"{dev:.2f}"
            busy = f"{100 * dev / wall:.1f}%"
            busy_prof = f"{100 * busy_prof:.1f}%"
        log(f"[{tag}] llama2-7b decode, 4 slots at 200-364 tokens, {mode}: "
            f"wall {wall:.2f} ms/step (synchronized clock around the decode "
            f"loop, {steps} steps), host launch calls {launches:.1f}/step, "
            f"device kernels {dev_s} ms/step (torch.profiler over 6 steps), "
            f"device busy {busy} of the wall (device kernel ms over wall ms; "
            f"{busy_prof} within the profiled window) on {smi}")
    log(f"[{tag}] llama2-7b decode, overlap, every row sampled (temperature "
        f"0.8, top-k 20, top-p 0.9): wall {wall_s:.2f} ms/step ({steps_s} "
        f"steps; greedy {walls['overlap'][0]:.2f}) on {smi}")
    del sync, olap, core, ocore
    gc.collect()
    torch.cuda.empty_cache()

    cfg, sync = build_client("zamba2-7b", reduced=False, seed=0,
                             device="cuda", **kw)
    core = sync.router.cores[0]
    olap = ServingClient(cfg, core.params, overlap=True, device="cuda", **kw)
    zp = prompts[:4]
    z_sync, rz_s = _overlap_streams(torch, sync, zp, 16)
    z_over, rz_o = _overlap_streams(torch, olap, zp, 16)
    _check_graph_run(core, rz_s, tag, "zamba2-7b sync")
    _check_graph_run(olap.router.cores[0], rz_o, tag, "zamba2-7b overlap")
    if z_sync != z_over:
        raise AssertionError(f"[{tag}] zamba2-7b: overlap differs from sync")
    log(f"[{tag}] zamba2-7b W8A8 greedy, 4 requests x 16 tokens: sync graph "
        f"and overlap identical; decode steps {rz_s['steps']} / "
        f"{rz_o['steps']}, replays {rz_s['replays']} / {rz_o['replays']}; "
        f"overlap launches {rz_o['counts']}")
    zw = {mode: _decode_wall(torch, c, tprompts, 32)
          for mode, c in (("sync graph", sync), ("overlap", olap))}
    log(f"[{tag}] zamba2-7b decode, 4 slots at 200-332 tokens: wall "
        + ", ".join(f"{mode} {w:.2f} ms/step ({n} steps)"
                    for mode, (w, n) in zw.items())
        + f" (synchronized clock around the decode loop) on {smi}")
    del sync, olap, core
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# chunked prefill and int8 KV pools at full width
# ---------------------------------------------------------------------------

CHUNK_BUDGET = 128
# two engines' greedy streams (chunked and one-shot prefill, int8 and bf16
# pools) are compared on margin-checked prompts, after the method of
# tests/test_quant_serving.py:83-99: a prompt is kept where, with both
# paths fed the first path's greedy tokens, they pick the same token at
# every step with a top-1 / top-2 logit margin above MARGIN on both (the
# engines run the same computations but may batch a row differently).  At
# llama2-7b's full width with random weights the top-1 margins are ~0.01
# and two such paths drift apart by ~0.25 in the logits within a few
# tokens, so the streams are compared over MARGIN_TOKENS tokens
MARGIN = 1e-2
MARGIN_TOKENS = 4


def _new_cache(torch, cfg, slots: int, kv_dtype: str) -> dict:
    """A paged cache of ``slots`` slots of 1024 tokens (page 16), each
    slot's block row its own pages in descending order."""
    from repro_torch.models import model as M

    cache = M.init_paged_cache(cfg, slots, 1024, page_size=16, device="cuda",
                               kv_dtype=kv_dtype)
    n = slots * 64
    cache["block"] = torch.arange(n, 0, -1, dtype=torch.int32,
                                  device="cuda").reshape(slots, 64)
    return cache


def _chunked_logits(torch, params, cfg, prompt, budget, cache, slot=0,
                    start=0):
    """Prefill ``prompt[start:]`` into ``slot`` of ``cache`` (block table
    set, the first ``start`` positions already written) in chunks of
    ``budget`` tokens in the engine's buckets (floor = page size); returns
    the last chunk's logits [V]."""
    from repro_torch.models import model as M
    from repro_torch.serving.kv_cache import chunk_spans, prefill_bucket

    page = cache["k"].shape[2]
    cap = cache["block"].shape[1] * page
    for pos, n in chunk_spans(len(prompt) - start, budget):
        pos += start
        toks = torch.zeros(min(prefill_bucket(n, floor=page), cap),
                           dtype=torch.int32)
        toks[:n] = torch.tensor(prompt[pos:pos + n], dtype=torch.int32)
        logits, cache = M.prefill_chunk_into_slot(
            params, cfg, toks.to("cuda"), pos, n, cache, slot)
    return logits


def _chunk_invariance(torch, params, cfg, prompt, budgets, kv_dtype: str,
                      tag: str) -> None:
    """``prompt`` through the chunk path at each budget, then 5 greedy
    decode steps: the slot's valid K/V rows (and scales), the first
    token's logits and the 5 decode logits must equal the one-chunk run's
    (budget len(prompt)) bit for bit."""
    from repro_torch.models import blocks
    from repro_torch.models import model as M

    runs = {}
    for budget in budgets:
        cache = _new_cache(torch, cfg, 2, kv_dtype)
        t0 = time.perf_counter()
        logits = _chunked_logits(torch, params, cfg, prompt, budget, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pages = cache["block"][0].long()
        rows = {key: cache[key][:, pages].flatten(1, 2)[:, :len(prompt)]
                .clone() for key in blocks.paged_pool_keys(cache)}
        out = [logits.clone()]
        tok = torch.zeros(2, dtype=torch.int32, device="cuda")
        active = torch.tensor([True, False], device="cuda")
        for _ in range(5):
            tok[0] = torch.argmax(out[-1])
            step, cache = M.decode_step_paged(params, cfg, tok, cache, active)
            out.append(step[0].clone())
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(x).all()) for x in out):
            raise AssertionError(f"[{tag}] budget {budget}: non-finite logits")
        runs[budget] = (out, rows, wall)
        del cache
    one, one_rows, _ = runs[len(prompt)]
    for budget, (out, rows, wall) in runs.items():
        same_rows = all(torch.equal(rows[k], one_rows[k]) for k in rows)
        same = [torch.equal(a, b) for a, b in zip(out, one)]
        log(f"[{tag}] {kv_dtype} pools, a {len(prompt)}-token prompt in "
            f"chunks of {budget} ({-(-len(prompt) // budget)} chunks, "
            f"{wall * 1e3:.0f} ms): valid K/V rows "
            f"{'bit-equal' if same_rows else 'DIFFERENT'}, first-token "
            f"logits {'bit-equal' if same[0] else 'DIFFERENT'}, decode "
            f"logits bit-equal at {sum(same[1:])} of 5 steps to the "
            f"one-chunk run")
        if not same_rows or not all(same):
            raise AssertionError(f"[{tag}] chunked != one-shot at budget "
                                 f"{budget} under {kv_dtype} pools")


def _paired_logits(torch, params, cfg, prompts, n_new, paths, tokens=None):
    """Greedy logits of ``prompts`` (4 at a time) along each path of
    ``paths`` (name -> (kv_dtype, chunk budget, 0 for the one-shot group
    prefill)), every path fed the first path's greedy tokens.  Returns
    (margins, drifts, agree): per prompt the smallest top-1 / top-2 margin
    over the paths and steps, the largest |logit difference| of the other
    paths to the first, and whether every path picks the first path's
    token at every step; with ``tokens``, the first path's greedy tokens
    of each prompt are appended to it."""
    from repro_torch.models import model as M
    from repro_torch.serving.kv_cache import prefill_bucket

    margins, drifts, agree = [], [], []
    names = list(paths)
    for i0 in range(0, len(prompts), 4):
        group = prompts[i0:i0 + 4]
        m = len(group)
        logits, caches = {}, {}
        for name, (kv_dtype, budget) in paths.items():
            cache = _new_cache(torch, cfg, 4, kv_dtype)
            if budget:
                first = torch.stack([_chunked_logits(
                    torch, params, cfg, p, budget, cache, slot)
                    for slot, p in enumerate(group)])
            else:
                bucket = prefill_bucket(max(len(p) for p in group))
                toks = torch.tensor([p + [0] * (bucket - len(p))
                                     for p in group], device="cuda")
                ex, extra = _prefill_extras(torch, cfg, m)
                first, cache = M.prefill_into_slots(
                    params, cfg, toks, torch.tensor(
                        [len(p) + extra for p in group], device="cuda"),
                    cache, torch.arange(m, device="cuda"), ex)
            logits[name], caches[name] = [first.float()], cache
        active = torch.arange(4, device="cuda") < m
        for _ in range(n_new - 1):
            tok = torch.zeros(4, dtype=torch.int32, device="cuda")
            tok[:m] = torch.argmax(logits[names[0]][-1], -1).to(torch.int32)
            for name in names:
                step, caches[name] = M.decode_step_paged(
                    params, cfg, tok, caches[name], active)
                logits[name].append(step[:m].float())
        ref = torch.stack(logits[names[0]])              # [steps, m, V]
        margin = torch.full((m,), float("inf"), device="cuda")
        drift = torch.zeros(m, device="cuda")
        same = torch.ones(m, dtype=torch.bool, device="cuda")
        for name in names:
            path = torch.stack(logits[name])
            top2 = torch.topk(path, 2, dim=-1).values
            margin = torch.minimum(margin, (top2[..., 0] - top2[..., 1])
                                   .amin(0))
            drift = torch.maximum(drift, (path - ref).abs().amax(-1).amax(0))
            same &= (path.argmax(-1) == ref.argmax(-1)).all(0)
        margins += margin.tolist()
        drifts += drift.tolist()
        agree += same.tolist()
        if tokens is not None:
            tokens += ref.argmax(-1).T.tolist()
        del caches
    return margins, drifts, agree


def _streams(torch, client, prompts, max_new):
    """Greedy streams of ``prompts`` through ``client``."""
    handles = [client.submit(p, max_new_tokens=max_new) for p in prompts]
    client.run()
    torch.cuda.synchronize()
    return [h.request.out_tokens for h in handles]


def _margin_checked_streams(torch, params, cfg, prompts, n_new, paths,
                            clients, tag: str) -> None:
    """Greedy streams of the two ``clients`` (one per path, in ``paths``'s
    order) must agree on every margin-checked prompt (MARGIN); at least two
    of the prompts must pass the check."""
    chosen = _margin_checked(torch, params, cfg, prompts, n_new, paths, tag)
    a, b = (_streams(torch, c, chosen, n_new) for c in clients)
    _same_streams(a, b, len(chosen), n_new, tag)


def _same_streams(a, b, n: int, n_new: int, tag: str) -> None:
    if a != b:
        bad = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        raise AssertionError(f"[{tag}] the engines' greedy streams differ "
                             f"on margin-checked prompts {bad}")
    log(f"[{tag}] the greedy streams are identical on the {n} "
        f"margin-checked prompts ({n_new} tokens each)")


def _margin_checked(torch, params, cfg, prompts, n_new, paths,
                    tag: str) -> list:
    """The prompts on which every path of ``paths`` picks the same greedy
    tokens with a top-1 margin above MARGIN (``_paired_logits``); at least
    two must pass."""
    margins, drifts, agree = _paired_logits(torch, params, cfg, prompts,
                                            n_new, paths)
    keep = [i for i, (mg, ok) in enumerate(zip(margins, agree))
            if ok and mg > MARGIN]
    log(f"[{tag}] {' vs '.join(paths)}: per prompt (top-1 margin, max "
        f"|dlogit| between the paths, same tokens) over {n_new} greedy "
        f"tokens: "
        + ", ".join(f"({mg:.4f}, {dr:.4f}, {'y' if ok else 'n'})"
                    for mg, dr, ok in zip(margins, drifts, agree))
        + f"; {len(keep)} of {len(prompts)} kept (same tokens, margin above "
          f"{MARGIN})")
    if len(keep) < 2:
        raise AssertionError(f"[{tag}] fewer than 2 margin-checked prompts")
    return [prompts[i] for i in keep]


def _bit_equal_streams(torch, params, cfg, prompts, n_new, paths, clients,
                       tag: str) -> None:
    """The two paths' greedy logits (``_paired_logits``) must be bit-equal
    at every step of every prompt, and the two ``clients``' greedy streams
    equal on every prompt: no margin filter."""
    margins, drifts, agree = _paired_logits(torch, params, cfg, prompts,
                                            n_new, paths)
    same = sum(dr == 0.0 and ok for dr, ok in zip(drifts, agree))
    log(f"[{tag}] {' vs '.join(paths)}: per prompt (top-1 margin, max "
        f"|dlogit| between the paths) over {n_new} greedy tokens: "
        + ", ".join(f"({mg:.4f}, {dr:.4f})" for mg, dr in zip(margins, drifts))
        + f"; logits bit-equal on {same} of {len(prompts)}")
    if same != len(prompts):
        raise AssertionError(f"[{tag}] the paths' logits differ on "
                             f"{len(prompts) - same} of {len(prompts)} "
                             f"prompts")
    a, b = (_streams(torch, c, prompts, n_new) for c in clients)
    bad = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    if bad:
        raise AssertionError(f"[{tag}] the engines' greedy streams differ "
                             f"on prompts {bad}")
    log(f"[{tag}] the two engines' greedy streams are identical on all "
        f"{len(prompts)} prompts ({n_new} tokens each)")


def _norm_rows_diagnostic(torch, cfg, params, tag: str) -> None:
    """Whether torch's row mean in rms_norm (a reduction whose launch
    configuration may depend on the row count) gives 16 rows other bits
    among the rows of a larger chunk bucket: printed, so that a failing
    chunked == one-shot check can be traced to it (the check is the gate)."""
    from repro_torch.models import blocks

    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((1024, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    gp = params["layers"][0]["attn_norm"]
    base = blocks.norm(cfg, gp, x[:16])
    diff = {m: int((blocks.norm(cfg, gp, x[:m])[:16] != base[:m])
                   .any(-1).sum())
            for m in (1, 2, 4, 8, 32, 64, 128, 256, 512, 1024)}
    log(f"[{tag}] rms_norm: rows of a 16-row batch that get other bits "
        f"among the first rows of m rows (rows 0..min(m,16)-1): "
        + ", ".join(f"m={m}: {n}" for m, n in diff.items()))


def _starvation(torch, client, cfg, smi: str, tag: str) -> None:
    """A 64-token request decoding alone, then a 512-token prompt admitted
    (4 chunks of 128): the short request must emit one token on every step
    the long one spends prefilling; each step's wall clock (synchronized)
    with and without a chunk in flight."""
    import numpy as np

    rng = np.random.RandomState(11)
    short = [int(t) for t in rng.randint(0, cfg.vocab_size, 64)]
    long = [int(t) for t in rng.randint(0, cfg.vocab_size, 512)]
    hs = client.submit(short, max_new_tokens=48)
    client.pump()
    torch.cuda.synchronize()
    plain = []
    for _ in range(6):
        t0 = time.perf_counter()
        evs = client.pump()
        torch.cuda.synchronize()
        plain.append(time.perf_counter() - t0)
        if sum(1 for e in evs if e.rid == hs.rid and e.token is not None) != 1:
            raise AssertionError(f"[{tag}] the short request missed a step")
    hl = client.submit(long, max_new_tokens=4)
    walls, per_step = [], []
    while hl.request.t_first_token == 0.0:
        t0 = time.perf_counter()
        evs = client.pump()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append(sum(1 for e in evs
                            if e.rid == hs.rid and e.token is not None))
        if len(walls) > 16:
            raise AssertionError(f"[{tag}] the long prompt never finished "
                                 f"prefilling")
    client.run()
    if hl.request.n_chunks != 4 or per_step != [1] * len(per_step):
        raise AssertionError(f"[{tag}] starvation: {hl.request.n_chunks} "
                             f"chunks, short tokens a step {per_step}")
    log(f"[{tag}] a 64-token request decoding while a 512-token prompt "
        f"prefills in {hl.request.n_chunks} chunks of {CHUNK_BUDGET}: one "
        f"token on each of those {len(per_step)} steps {per_step}; step "
        f"wall {statistics.median(walls) * 1e3:.2f} ms with a chunk in "
        f"flight (median of {len(walls)}), "
        f"{statistics.median(plain) * 1e3:.2f} ms without (median of "
        f"{len(plain)}; synchronous loop, synchronized clock) on {smi}")


def _chunk_times(torch, params, cfg, smi: str, tag: str) -> None:
    """ms per chunk (wall clock around one synchronized
    prefill_chunk_into_slot, median of 5) and device ms per chunk
    (torch.profiler, device activity only, over one chunk) at budgets 16,
    128 and 512, at cache start 0."""
    from repro_torch.models import model as M

    cache = _new_cache(torch, cfg, 1, "bf16")
    prompt = torch.randint(0, cfg.vocab_size, (512,),
                           generator=torch.Generator().manual_seed(12),
                           dtype=torch.int32)
    for budget in (16, 128, 512):
        toks = prompt[:budget].to("cuda")

        def call(_i=0):
            return M.prefill_chunk_into_slot(params, cfg, toks, 0, budget,
                                             cache, 0)

        call()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        rows = _kernel_rows(prof)
        dev = sum(r[0] for r in rows) / 1e3
        chunk_dev = sum(r[0] for r in rows
                        if "paged_chunk_attention_" in r[1]) / 1e3
        launches = sum(r[2] for r in rows)
        dev_s = (f"{launches:.0f} device kernels, {dev:.2f} ms, of which "
                 f"the chunk kernel {chunk_dev:.3f} ms" if dev > 0 else
                 "device time not measured (the profiler recorded none)")
        log(f"[{tag}] one chunk of {budget} tokens ({cfg.n_layers} layers, "
            f"W8A8, start 0): wall {statistics.median(walls) * 1e3:.2f} ms "
            f"(median of 5, synchronized), {dev_s}, on {smi}")


def _lap(tag: str, what: str, t0: float) -> float:
    now = time.monotonic()
    log(f"[{tag}] ({what}: {now - t0:.1f} s)")
    return now


def phase_serve_chunked(torch, smi: str) -> dict:
    """llama2-7b W8A8 at full width, cut to its first CUT_LAYERS layers,
    with a chunk budget of 128: the serve
    trace through the engine (counted), synchronous == overlapped (greedy;
    sampled rows in tests/test_torch_gpu.py), the engine against the
    one-shot engine bit for bit on 12 prompts (logits and streams),
    chunked == one-chunk bit for bit at budgets {1, 7, 16, 128, len}, no
    decode starvation, ms per chunk."""
    import gc

    import numpy as np

    from repro_torch.serving.client import ServingClient
    from repro_torch.serving.scheduler import make_scheduler

    tag = "serve_chunked"
    t0 = time.monotonic()
    counts, client = _serve_full(torch, "llama2-7b", tag, smi,
                                 chunk_prefill=CHUNK_BUDGET,
                                 required=("paged_chunk_attention",),
                                 layers=CUT_LAYERS)
    core = client.router.cores[0]
    cfg, params = core.cfg, core.params
    log(f"[{tag}] {core.stats.prefill_chunks} chunks of up to "
        f"{CHUNK_BUDGET} tokens, {core.stats.prefills} group prefills; "
        f"paged_chunk_attention launches {counts['paged_chunk_attention']} "
        f"({cfg.n_layers} a chunk)")
    if core.stats.prefill_chunks * cfg.n_layers \
            != counts["paged_chunk_attention"]:
        raise AssertionError(f"[{tag}] chunk kernel launches do not match "
                             f"the chunks run")
    _norm_rows_diagnostic(torch, cfg, params, tag)
    t0 = _lap(tag, "counted run", t0)
    kw = dict(max_batch=4, max_seq=1024, page_size=16, eos_id=-1,
              device="cuda")
    olap = ServingClient(cfg, params, overlap=True, scheduler=make_scheduler(
        "fcfs", chunk_tokens=CHUNK_BUDGET), **kw)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in rng.randint(64, 513, size=8)]

    a, ra = _overlap_streams(torch, client, prompts, 32)
    b, rb = _overlap_streams(torch, olap, prompts, 32)
    _check_graph_run(core, ra, tag, "sync")
    _check_graph_run(olap.router.cores[0], rb, tag, "overlap")
    if a != b:
        raise AssertionError(f"[{tag}] overlap differs from sync")
    log(f"[{tag}] greedy, 8 requests x 32 tokens with chunked admission: "
        f"sync and overlap identical; decode steps {ra['steps']} / "
        f"{rb['steps']}, chunk kernel launches "
        f"{ra['counts']['paged_chunk_attention']} / "
        f"{rb['counts']['paged_chunk_attention']}")
    del olap
    t0 = _lap(tag, "sync and overlap", t0)
    one_shot = ServingClient(cfg, params, **kw)
    rng = np.random.RandomState(5)
    cands = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
             for n in rng.randint(140, 400, size=12)]
    _bit_equal_streams(
        torch, params, cfg, cands, MARGIN_TOKENS,
        {"one-shot": ("bf16", 0), "chunked": ("bf16", CHUNK_BUDGET)},
        (one_shot, client), tag)
    del one_shot
    t0 = _lap(tag, "one-shot == chunked engines", t0)
    prompt = [int(t) for t in np.random.RandomState(7).randint(
        0, cfg.vocab_size, 150)]
    _chunk_invariance(torch, params, cfg, prompt, (1, 7, 16, 128, 150),
                      "bf16", tag)
    t0 = _lap(tag, "chunked == one-shot", t0)
    _starvation(torch, client, cfg, smi, tag)
    _chunk_times(torch, params, cfg, smi, tag)
    _lap(tag, "starvation and chunk times", t0)
    del client, core
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_serve_int8kv(torch, smi: str) -> tuple[dict, dict]:
    """llama2-7b W8A8 at full width with int8 KV pools: the serve trace
    through the engine (counted: B1-int8, never B1 over bf16), sync ==
    overlap bit for bit (greedy and sampled), the engine against the bf16
    engine on margin-checked prompts, chunked == one-shot bit for bit
    under int8 pools, a chunked int8 engine (counted: the chunk kernel's
    int8 variant), the pool's bytes and the decode step by kernel."""
    import gc

    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving.client import ServingClient
    from repro_torch.serving.scheduler import SamplingParams, make_scheduler

    tag = "serve_int8kv"
    counts, client = _serve_full(
        torch, "llama2-7b", tag, smi, kv_dtype="int8",
        required=("paged_decode_attention_int8",),
        serving=("int8_gemv", "int8_gemm_tc", "flash_attention"),
        layers=CUT_LAYERS)
    if counts["paged_decode_attention"]:
        raise AssertionError(f"[{tag}] B1 over bf16 pools launched with "
                             f"int8 pools")
    core = client.router.cores[0]
    cfg, params = core.cfg, core.params
    kw = dict(max_batch=4, max_seq=1024, page_size=16, eos_id=-1,
              device="cuda")
    olap = ServingClient(cfg, params, overlap=True, kv_dtype="int8", **kw)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in rng.randint(64, 513, size=8)]

    def stochastic(i):
        return (SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                               seed=100 + i) if i % 2 else None)

    for mode, sampling in (("greedy", None), ("stochastic", stochastic)):
        a, ra = _overlap_streams(torch, client, prompts, 32, sampling)
        b, rb = _overlap_streams(torch, olap, prompts, 32, sampling)
        _check_graph_run(core, ra, tag, f"{mode} sync")
        _check_graph_run(olap.router.cores[0], rb, tag, f"{mode} overlap")
        if a != b:
            raise AssertionError(f"[{tag}] {mode}: overlap differs from sync")
        log(f"[{tag}] {mode}, 8 requests x 32 tokens over int8 pools: sync "
            f"and overlap identical; decode steps {ra['steps']} / "
            f"{rb['steps']}, B1-int8 launches "
            f"{ra['counts']['paged_decode_attention_int8']} / "
            f"{rb['counts']['paged_decode_attention_int8']}")
    del olap
    bf16 = ServingClient(cfg, params, **kw)
    bf16_core = bf16.router.cores[0]
    rng = np.random.RandomState(6)
    cands = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
             for n in rng.randint(64, 400, size=12)]
    _margin_checked_streams(
        torch, params, cfg, cands, MARGIN_TOKENS,
        {"bf16 pools": ("bf16", 0), "int8 pools": ("int8", 0)},
        (bf16, client), tag)
    per_tok = {name: c.kv_page_bytes / c.page_size
               for name, c in (("bf16", bf16_core), ("int8", core))}
    pool = {name: c.kv_page_bytes * c.num_pages / 2**30
            for name, c in (("bf16", bf16_core), ("int8", core))}
    log(f"[{tag}] KV pool, 4 slots x 1024 tokens (page 16, "
        f"{core.num_pages} pages): int8 {per_tok['int8'] / 1024:.1f} KiB a "
        f"token, {pool['int8']:.3f} GiB (scales included); bf16 "
        f"{per_tok['bf16'] / 1024:.1f} KiB a token, {pool['bf16']:.3f} GiB")
    del bf16, bf16_core
    prompt = [int(t) for t in np.random.RandomState(7).randint(
        0, cfg.vocab_size, 150)]
    _chunk_invariance(torch, params, cfg, prompt, (7, 16, 128, 150), "int8",
                      tag)
    chunked = ServingClient(cfg, params, kv_dtype="int8",
                            scheduler=make_scheduler(
                                "fcfs", chunk_tokens=CHUNK_BUDGET), **kw)
    handles = [chunked.submit(p, max_new_tokens=16) for p in prompts[:4]]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    chunked.run()
    torch.cuda.synchronize()
    counts_chunked = kernels.launch_counts()
    if not all(h.finished and len(h.request.out_tokens) == 16
               for h in handles):
        raise AssertionError(f"[{tag}] the chunked int8 engine did not "
                             f"finish its requests")
    for k in ("paged_chunk_attention_int8", "paged_decode_attention_int8"):
        if counts_chunked[k] <= 0:
            raise AssertionError(f"[{tag}] the chunked int8 engine never "
                                 f"launched {k}")
    log(f"[{tag}] chunk budget {CHUNK_BUDGET} over int8 pools, 4 requests x "
        f"16 tokens: {chunked.router.cores[0].stats.prefill_chunks} chunks; "
        f"launches {counts_chunked}")
    del chunked
    phase_profile(torch, client, smi, tag)
    del client, core
    gc.collect()
    torch.cuda.empty_cache()
    return counts, counts_chunked


# ---------------------------------------------------------------------------
# the flash KV tier, the prefix cache and slot migration (ROADMAP A5)
# ---------------------------------------------------------------------------
A5_ENG = dict(max_batch=4, max_seq=1024, page_size=16, eos_id=-1,
              device="cuda")
# serve_tiered's hot pool: 64 usable pages (1,024 tokens) under 4 slots of
# up to 544 tokens; zamba2-7b's: 40 pages (640 tokens) under 4 of up to 272
TIER_PAGES = 65
TIER_HYBRID_PAGES = 41
TIER_FLASH_BOUND = 16
PREFIX_CHUNK = 256    # below every prompt of the chat trace: all chunk

PREFIX_CACHED = 256   # the cached prefix of the margin-checked partial hits
_FULL: dict = {}


def _full_model(torch, arch: str):
    """(cfg, params) of ``arch`` at full width, W8A8, built once for the A5
    phases (its build engine's pool freed)."""
    if arch not in _FULL:
        import gc

        from repro_torch.launch.serve import build_client

        t0 = time.monotonic()
        cfg, client = build_client(arch, reduced=False, quant="w8a8",
                                   max_batch=4, max_seq=1024, seed=0,
                                   device="cuda")
        _FULL[arch] = (cfg, client.router.cores[0].params)
        del client
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[a5] {arch} full width W8A8 built in "
            f"{time.monotonic() - t0:.1f} s")
    return _FULL[arch]


def _drop_full(torch, arch: str) -> None:
    import gc

    _FULL.pop(arch, None)
    gc.collect()
    torch.cuda.empty_cache()


def _a5_engine(cfg, params, **kw):
    from repro_torch.serving.core import EngineCore

    return EngineCore(cfg, params, **{**A5_ENG, **kw})


def _serve_trace(cfg, n: int = 8) -> list[list[int]]:
    """The serve phase's prompts: ``n`` of 64-512 tokens from seed 0."""
    import numpy as np

    rng = np.random.RandomState(0)
    return [[int(t) for t in rng.randint(0, cfg.vocab_size, k)]
            for k in rng.randint(64, 513, size=8)][:n]


def _run_trace(torch, eng, prompts, max_new: int, tag: str
               ) -> tuple[list, float]:
    """Every prompt submitted at once, the engine run to its end; each
    request must finish with ``max_new`` tokens in the vocabulary.
    Returns (streams, synchronized wall s)."""
    from repro_torch.serving.core import Request

    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if not r.done or len(r.out_tokens) != max_new or not all(
                0 <= t < eng.cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"[{tag}] request {r.rid}: done={r.done} "
                                 f"reason={r.finish_reason} "
                                 f"n={len(r.out_tokens)}")
    return [r.out_tokens for r in reqs], wall


def _step_ms(eng) -> float:
    return eng.stats.wall_decode_s * 1e3 / max(eng.stats.decode_steps, 1)


def _page_transfer_ms(torch, eng, n: int = 16, reps: int = 5
                      ) -> tuple[float, float]:
    """(ms a page spilled, ms a page prefetched), synchronized, median of
    ``reps``: ``n`` pages of random content gathered and copied to pinned
    host memory (the spill, up to its event), then written back from the
    host onto the same pids (the prefetch: the pinned stacking, the copy
    and the in-place scatter).  Every round trip must return the bits."""
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.serving.core import _LazyPagePayload, _SpillBatch

    pids = eng.allocator.alloc(n)
    ids = eng._page_ids(pids)
    keys = blocks.paged_pool_keys(eng.cache)
    gen = torch.Generator(device="cuda").manual_seed(21)
    for k in keys:
        pool = eng.cache[k]
        shape = (pool.shape[0], n, *pool.shape[2:])
        if pool.dtype == torch.int8:
            val = torch.randint(-127, 128, shape, generator=gen,
                                device="cuda", dtype=torch.int8)
        else:
            val = torch.randn(shape, generator=gen, device="cuda").to(
                pool.dtype)
        pool.index_copy_(1, ids, val)
    want = [eng.cache[k].index_select(1, ids) for k in keys]
    outs, ins = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = _SpillBatch(M.swap_out_pages(eng.cache, ids))
        batch.wait()
        outs.append(time.perf_counter() - t0)
        for k in keys:
            eng.cache[k].index_fill_(1, ids, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._scatter_pages(pids, [_LazyPagePayload(batch, j)
                                  for j in range(n)])
        torch.cuda.synchronize()
        ins.append(time.perf_counter() - t0)
        if not all(torch.equal(eng.cache[k].index_select(1, ids), w)
                   for k, w in zip(keys, want)):
            raise AssertionError("a page round trip through the host "
                                 "changed its bits")
    eng.allocator.free(pids)
    return (statistics.median(outs) * 1e3 / n,
            statistics.median(ins) * 1e3 / n)


def _tier_line(tag, name, eng, wall, same, res_wall, res_step) -> None:
    s = eng.stats
    mib = eng.kv_page_bytes / 2**20
    log(f"[{tag}] {name}: streams {'bit-equal to' if same else 'DIFFER from'}"
        f" the resident engine's; preemptions {s.preemptions}, resumes "
        f"{s.resumes}, OutOfPages absorbed {s.pool_exhausted}; spilled "
        f"{s.kv_spill_pages} pages ({s.kv_spill_pages * mib:.0f} MiB), "
        f"prefetched {s.kv_prefetch_pages} ({s.kv_prefetch_pages * mib:.0f} "
        f"MiB); decode steps {s.decode_steps} (resident "
        f"{res_step[1]}), wall {wall:.2f} s (resident {res_wall:.2f} s), "
        + (f"decode dispatch a step {_step_ms(eng):.2f} ms (the overlapped "
           f"loop's wall_decode_s: host time, the compute not awaited; "
           f"resident sync wall {res_step[0]:.2f} ms)" if eng.overlap else
           f"decode wall a step {_step_ms(eng):.2f} ms (resident "
           f"{res_step[0]:.2f} ms)"))


def phase_serve_tiered(torch, smi: str) -> None:
    """llama2-7b W8A8 at full width, 4 slots, kv_tier="flash" over a
    65-page hot pool (1,024 tokens) against the serve trace (up to 4 x 544
    tokens): the streams equal the resident engine's bit for bit,
    synchronous and overlapped, with spills, prefetches and preemptions; a
    bounded tier (16 pages) finishes every request; the same with int8
    pools.  ms a page each way.  Then zamba2-7b: 4 requests over a 41-page
    pool equal the resident engine's, the Mamba state restored on resume."""
    import gc

    tag = "serve_tiered"
    t0 = time.monotonic()
    cfg, params = _full_model(torch, "llama2-7b")
    prompts = _serve_trace(cfg)
    for kv in ("bf16", "int8"):
        res = _a5_engine(cfg, params, kv_dtype=kv)
        want, res_wall = _run_trace(torch, res, prompts, 32, tag)
        res_step = (_step_ms(res), res.stats.decode_steps)
        del res
        variants = [("sync", {})]
        if kv == "bf16":
            variants += [("overlap", {"overlap": True}),
                         ("bounded", {"flash_pages": TIER_FLASH_BOUND})]
        for name, extra in variants:
            eng = _a5_engine(cfg, params, kv_dtype=kv, kv_tier="flash",
                             num_pages=TIER_PAGES, **extra)
            got, wall = _run_trace(torch, eng, prompts, 32, tag)
            s = eng.stats
            _tier_line(tag, f"{kv} pools, {name}, {TIER_PAGES} hot pages"
                       + (f", tier of {TIER_FLASH_BOUND} pages"
                          if name == "bounded" else ""),
                       eng, wall, got == want, res_wall, res_step)
            if eng.allocator.available != TIER_PAGES - 1 \
                    or eng.allocator.cold_count or any(eng.suspended):
                raise AssertionError(f"[{tag}] {kv} {name}: pages leaked")
            if name != "bounded":
                if got != want:
                    raise AssertionError(f"[{tag}] {kv} {name}: tiered != "
                                         f"resident")
                if not (s.kv_spill_pages > 0 and s.preemptions > 0
                        and s.kv_prefetch_pages == s.kv_spill_pages):
                    raise AssertionError(f"[{tag}] {kv} {name}: the tier "
                                         f"never spilled and prefetched")
            if kv == "bf16" and name == "sync":
                out_ms, in_ms = _page_transfer_ms(torch, eng)
                mb = eng.kv_page_bytes / 1e6
                log(f"[{tag}] a {eng.kv_page_bytes / 2**20:.0f} MiB page "
                    f"(16 pages a call, median of 5, synchronized): spill "
                    f"{out_ms:.3f} ms ({mb / out_ms:.1f} GB/s), prefetch "
                    f"{in_ms:.3f} ms ({mb / in_ms:.1f} GB/s), on {smi}")
            del eng
            gc.collect()
    t0 = _lap(tag, "llama2-7b", t0)
    hcfg, hparams = _full_model(torch, "zamba2-7b")
    hprompts = _serve_trace(hcfg, 4)
    res = _a5_engine(hcfg, hparams)
    want, res_wall = _run_trace(torch, res, hprompts, 16, tag)
    res_step = (_step_ms(res), res.stats.decode_steps)
    del res
    eng = _a5_engine(hcfg, hparams, kv_tier="flash",
                     num_pages=TIER_HYBRID_PAGES)
    got, wall = _run_trace(torch, eng, hprompts, 16, tag)
    _tier_line(tag, f"zamba2-7b, {TIER_HYBRID_PAGES} hot pages", eng, wall,
               got == want, res_wall, res_step)
    s = eng.stats
    if got != want or not (s.preemptions > 0 and s.resumes > 0
                           and s.kv_spill_pages > 0) or eng._ssm_ckpt:
        raise AssertionError(f"[{tag}] zamba2-7b: tiered != resident, or no "
                             f"suspension and resume")
    del eng
    _drop_full(torch, "zamba2-7b")
    _lap(tag, "zamba2-7b", t0)


def _chat_sessions(cfg, max_seq: int = 1024, page: int = 16,
                   n_sessions: int = 4, n_turns: int = 3,
                   user_len: int = 4, m: int = 4):
    """The multi-turn chat trace of the JAX package's
    benchmarks/bench_serving.py make_prefix_sessions: per session a
    page-aligned system prompt that fills max_seq with the turns, and a
    user span a turn; odd sessions sample with a pinned seed."""
    import numpy as np

    from repro_torch.serving.scheduler import SamplingParams

    sys_len = ((max_seq - n_turns * (user_len + m)) // page) * page
    rng = np.random.RandomState(5)
    return [{"sid": f"sess-{s}",
             "system": rng.randint(0, cfg.vocab_size, sys_len).tolist(),
             "users": [rng.randint(0, cfg.vocab_size, user_len).tolist()
                       for _ in range(n_turns)],
             "sampling": (None if s % 2 == 0 else SamplingParams(
                 temperature=0.8, top_k=20, seed=1000 + s))}
            for s in range(n_sessions)], m, n_turns


def _chat(torch, eng, cfg, tag: str) -> dict:
    """One pass over the chat trace: sessions interleave turn by turn and
    every turn is submitted again at once (an exact-prompt resubmission);
    histories grow from the engine's own outputs.  Returns {(turn, session,
    kind): (stream, ttft s)}."""
    from repro_torch.serving.core import Request

    sessions, m, n_turns = _chat_sessions(cfg)
    history = {s["sid"]: list(s["system"]) for s in sessions}
    out, rid = {}, 0
    for t in range(n_turns):
        for k, sess in enumerate(sessions):
            prompt = history[sess["sid"]] + sess["users"][t]
            for kind in ("turn", "regen"):
                req = Request(rid=rid, prompt=list(prompt), max_new_tokens=m,
                              session=sess["sid"],
                              sampling=sess["sampling"])
                rid += 1
                eng.add_request(req)
                eng.run()
                torch.cuda.synchronize()
                if not req.done or len(req.out_tokens) != m:
                    raise AssertionError(f"[{tag}] request {req.rid} did not "
                                         f"complete")
                out[(t, k, kind)] = (list(req.out_tokens), req.ttft_s)
            history[sess["sid"]] = prompt + out[(t, k, "turn")][0]
    return out


def _partial_paths(torch, params, cfg, prompt, primer, n_new):
    """Greedy logits of ``prompt`` two ways on a fresh cache: a one-shot
    prefill, and the partial hit's path (the primer's one-shot prefill
    writes the cached pages, then the suffix from PREFIX_CACHED runs
    through the chunk path), each then decoding the first path's tokens.
    Returns (smallest top-1 margin, max |dlogit|, same tokens)."""
    from repro_torch.models import model as M
    from repro_torch.serving.kv_cache import prefill_bucket

    outs, caches = [], []
    for partial in (False, True):
        cache = _new_cache(torch, cfg, 1, "bf16")
        first = primer if partial else prompt
        b = prefill_bucket(len(first))
        logits, cache = M.prefill_into_slots(
            params, cfg, torch.tensor([first + [0] * (b - len(first))],
                                      device="cuda"),
            torch.tensor([len(first)], device="cuda"), cache,
            torch.tensor([0], device="cuda"))
        logits = logits[0]
        if partial:   # the engine's partial hit: one chunk, no budget
            logits = _chunked_logits(torch, params, cfg, prompt, len(prompt),
                                     cache, start=PREFIX_CACHED)
        outs.append([logits.float()])
        caches.append(cache)
    active = torch.tensor([True], device="cuda")
    for _ in range(n_new - 1):
        tok = torch.argmax(outs[0][-1]).to(torch.int32).reshape(1)
        for p in (0, 1):
            step, caches[p] = M.decode_step_paged(params, cfg, tok,
                                                  caches[p], active)
            outs[p].append(step[0].float())
    a, b = torch.stack(outs[0]), torch.stack(outs[1])
    margin = min(float((torch.topk(x, 2, -1).values[:, 0]
                        - torch.topk(x, 2, -1).values[:, 1]).min())
                 for x in (a, b))
    same = bool((a.argmax(-1) == b.argmax(-1)).all())
    return margin, float((a - b).abs().max()), same


def _prefill_device_ms(torch, fn) -> tuple[float, float]:
    """(wall ms, synchronized, median of 3; device kernel ms from
    torch.profiler over one call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return (statistics.median(walls) * 1e3,
            sum(r[0] for r in _kernel_rows(prof)) / 1e3)


def phase_serve_prefix(torch, smi: str) -> None:
    """llama2-7b W8A8 at full width, cut to its first CUT_LAYERS layers,
    prefix caching on the JAX benchmark's chat trace (4 sessions, 3 turns,
    a 992-token system prompt, every turn submitted twice).  Gates: resume
    hits replay the cold run's bits with no prefill; the one-shot pair and
    a chunked pair (chunk budget 256 below every prompt) each give their
    cold run's 24 streams bit for bit,
    partial hits included; on 8 more prompts a partial hit over one-shot
    pages gives the one-shot run's logits and the cold engine's stream;
    refcounts return to idle; B1 and the chunk kernel counted.  TTFT p50 cold and warm; prefill device ms of a cold
    prompt against a partial hit's suffix."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.models import model as M
    from repro_torch.serving.core import Request
    from repro_torch.serving.kv_cache import prefill_bucket
    from repro_torch.serving.scheduler import make_scheduler

    tag = "serve_prefix"
    t0 = time.monotonic()
    cfg, params = _cut_depth(*_full_model(torch, "llama2-7b"), CUT_LAYERS)
    log(f"[{tag}] llama2-7b's first {CUT_LAYERS} layers at full width")
    cold = _chat(torch, _a5_engine(cfg, params), cfg, tag)
    warm_eng = _a5_engine(cfg, params, prefix_cache=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    warm = _chat(torch, warm_eng, cfg, tag)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    s = warm_eng.stats
    n_sess = 4
    regen_ok = all(warm[(t, k, "regen")][0] == warm[(t, k, "turn")][0]
                   for t, k, kind in warm if kind == "turn")
    first_ok = all(warm[(0, k, kind)][0] == cold[(0, k, kind)][0]
                   for k in range(n_sess) for kind in ("turn", "regen"))
    agree = sum(warm[key][0] == cold[key][0] for key in warm
                if key[0] > 0 and key[2] == "turn")
    same_os = sum(warm[key][0] == cold[key][0] for key in warm)
    log(f"[{tag}] one-shot engines, 24 requests (4 sessions x 3 turns x 2): "
        f"prefills {s.prefills}, prefill chunks {s.prefill_chunks}, prefix "
        f"hits {s.prefix_hits}/{s.prefix_lookups}, pages {s.prefix_hit_pages}"
        f", tokens {s.prefix_tokens_reused}, cow {s.cow_copies}; resume hits "
        f"equal their turn: {regen_ok}; turn 0 (both kinds) equal the cold "
        f"engine's: {first_ok}; {same_os} of 24 streams bit-equal to the "
        f"cold one-shot engine's, the later turns (partial hits: the chunk "
        f"kernel over B3's pages) {agree} of 8; launches B1 "
        f"{counts['paged_decode_attention']}, chunk kernel "
        f"{counts['paged_chunk_attention']}, B3 {counts['flash_attention']}")
    if not (regen_ok and first_ok):
        raise AssertionError(f"[{tag}] a resume hit differs from its cold "
                             f"run")
    if same_os != 24:
        raise AssertionError(f"[{tag}] a prefix hit over one-shot pages "
                             f"differs from the cold one-shot run")
    if (s.prefills, s.prefill_chunks, s.prefix_hits) != (n_sess, 8, 20):
        raise AssertionError(f"[{tag}] resume hits ran a prefill, or the "
                             f"partial hits did not chunk")
    if counts["paged_decode_attention"] <= 0 \
            or counts["paged_chunk_attention"] <= 0:
        raise AssertionError(f"[{tag}] B1 or the chunk kernel never ran")
    idle = all(warm_eng.allocator.refcount(e.pid) == 0
               for e in warm_eng._px._pages.values() if not e.cold)
    n_entries = len(warm_eng._px)
    if not idle or (warm_eng.allocator.available + warm_eng._px_reclaimable
                    != warm_eng.num_pages - 1) \
            or warm_eng.clear_prefix_cache() != n_entries \
            or warm_eng.allocator.available != warm_eng.num_pages - 1:
        raise AssertionError(f"[{tag}] refcounts did not return to idle")
    ttft_c = [v[1] for v in cold.values()]
    ttft_res = [warm[k][1] for k in warm if k[2] == "regen"]
    ttft_par = [warm[k][1] for k in warm if k[2] == "turn" and k[0] > 0]
    ttft_w = ttft_res + ttft_par
    log(f"[{tag}] TTFT p50 cold {statistics.median(ttft_c) * 1e3:.1f} ms "
        f"(24 requests); warm hits {statistics.median(ttft_w) * 1e3:.1f} ms"
        f" (20): resume hits {statistics.median(ttft_res) * 1e3:.1f} ms "
        f"(12), partial hits {statistics.median(ttft_par) * 1e3:.1f} ms "
        f"(8), on {smi}")
    del warm_eng
    t0 = _lap(tag, "one-shot engines", t0)
    sched = make_scheduler("fcfs", chunk_tokens=PREFIX_CHUNK)
    cold_c = _chat(torch, _a5_engine(cfg, params, scheduler=sched), cfg, tag)
    warm_c_eng = _a5_engine(cfg, params, prefix_cache=True,
                            scheduler=make_scheduler(
                                "fcfs", chunk_tokens=PREFIX_CHUNK))
    warm_c = _chat(torch, warm_c_eng, cfg, tag)
    same = sum(warm_c[k][0] == cold_c[k][0] for k in warm_c)
    sc = warm_c_eng.stats
    log(f"[{tag}] chunk budget {PREFIX_CHUNK} (every prompt chunks): "
        f"{same} of 24 streams bit-equal to the cold chunked engine's "
        f"(prefix hits {sc.prefix_hits}, partial {sc.prefix_hits - 12}, "
        f"chunks {sc.prefill_chunks})")
    if same != 24 or sc.prefix_hits != 20:
        raise AssertionError(f"[{tag}] a same-path prefix hit differs from "
                             f"the cold run")
    del warm_c_eng
    t0 = _lap(tag, "same-path engines", t0)
    rng = np.random.RandomState(13)
    cands = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
             for n in rng.randint(PREFIX_CACHED + 20, 480, size=8)]
    primers = [c[:PREFIX_CACHED] + [(c[PREFIX_CACHED] + 1) % cfg.vocab_size]
               for c in cands]
    checks = [_partial_paths(torch, params, cfg, c, p, MARGIN_TOKENS)
              for c, p in zip(cands, primers)]
    equal = [i for i, (_mg, dr, ok) in enumerate(checks) if ok and dr == 0.0]
    log(f"[{tag}] partial hit (one-shot prefix of {PREFIX_CACHED} tokens + "
        f"chunked suffix) vs one-shot, per prompt (top-1 margin, max "
        f"|dlogit|) over {MARGIN_TOKENS} greedy tokens: "
        + ", ".join(f"({mg:.4f}, {dr:.4f})" for mg, dr, _ok in checks)
        + f"; logits bit-equal on {len(equal)} of {len(cands)}")
    if len(equal) != len(cands):
        raise AssertionError(f"[{tag}] a partial hit's logits over one-shot "
                             f"pages differ from the one-shot run's")
    cold_e = _a5_engine(cfg, params)
    warm_e = _a5_engine(cfg, params, prefix_cache=True)
    bad = []
    for i in range(len(cands)):
        a = Request(rid=3 * i, prompt=list(cands[i]),
                    max_new_tokens=MARGIN_TOKENS)
        cold_e.add_request(a)
        cold_e.run()
        warm_e.add_request(Request(rid=3 * i + 1, prompt=primers[i],
                                   max_new_tokens=1))
        warm_e.run()
        hits = warm_e.stats.prefix_hits
        b = Request(rid=3 * i + 2, prompt=list(cands[i]),
                    max_new_tokens=MARGIN_TOKENS)
        warm_e.add_request(b)
        warm_e.run()
        if warm_e.stats.prefix_hits != hits + 1:
            raise AssertionError(f"[{tag}] prompt {i} was not a partial hit")
        if a.out_tokens != b.out_tokens:
            bad.append(i)
    if bad:
        raise AssertionError(f"[{tag}] partial hits differ from the one-shot"
                             f" engine on prompts {bad}")
    log(f"[{tag}] partial hits equal the one-shot cold engine's streams on "
        f"all {len(cands)} prompts")
    del cold_e, warm_e
    sessions, _m, _n = _chat_sessions(cfg)
    sys_len = len(sessions[0]["system"])
    prompt = sessions[0]["system"] + sessions[0]["users"][0]
    cache = _new_cache(torch, cfg, 4, "bf16")
    bk = prefill_bucket(len(prompt))
    ms = {}
    for rows in (1, 4):   # a direct prefill; the engine's group of 4 rows
        toks = torch.tensor([prompt + [0] * (bk - len(prompt))] * rows,
                            device="cuda")
        n = torch.tensor([len(prompt)] * rows, device="cuda")
        slots = torch.zeros(rows, dtype=torch.long, device="cuda")
        ms[rows] = _prefill_device_ms(
            torch, lambda toks=toks, n=n, slots=slots: M.prefill_into_slots(
                params, cfg, toks, n, cache, slots))
    part_ms = _prefill_device_ms(torch, lambda: _chunked_logits(
        torch, params, cfg, prompt, len(prompt), cache, start=sys_len))
    log(f"[{tag}] prefill of a {len(prompt)}-token prompt: cold one-shot "
        f"as one row wall {ms[1][0]:.1f} ms, device {ms[1][1]:.2f} ms; as "
        f"the engine admits it alone (the row repeated to 4, bucket {bk}) "
        f"wall {ms[4][0]:.1f} ms, device {ms[4][1]:.2f} ms; a partial "
        f"hit's {len(prompt) - sys_len}-token suffix from {sys_len}: wall "
        f"{part_ms[0]:.1f} ms, device {part_ms[1]:.2f} ms, on {smi}")
    _lap(tag, "partial hits over one-shot pages and prefill times", t0)


def phase_serve_migrate(torch, smi: str) -> None:
    """Two llama2-7b W8A8 replicas on the one card sharing one params dict,
    behind Router(migrate=True, session_affinity): every request lands on
    a tiered replica whose 65-page pool starves, a full-pool donor beside
    it.  Gates: migrations > 0 and the streams equal one resident replica's
    bit for bit, synchronous and overlapped; a snapshot's bytes decode to
    equal pages and resume with the unmigrated stream.  Bytes a snapshot,
    ms to snapshot, encode, decode and inject."""
    import zlib

    from repro_torch.serving.core import Request, SlotSnapshot
    from repro_torch.serving.router import Router

    tag = "serve_migrate"
    t0 = time.monotonic()
    cfg, params = _full_model(torch, "llama2-7b")
    prompts = _serve_trace(cfg)
    want, res_wall = _run_trace(torch, _a5_engine(cfg, params), prompts, 32,
                                tag)
    for overlap in (False, True):
        starved = _a5_engine(cfg, params, num_pages=TIER_PAGES,
                             kv_tier="flash", overlap=overlap)
        donor = _a5_engine(cfg, params, overlap=overlap)
        cores = [None, None]
        hot = zlib.crc32(b"hot") % 2
        cores[hot], cores[1 - hot] = starved, donor
        rt = Router(cores, policy="session_affinity", migrate=True)
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=32,
                        session="hot") for i, p in enumerate(prompts)]
        for r in reqs:
            if rt.submit(r) is not starved:
                raise AssertionError(f"[{tag}] affinity missed the replica")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps = 0
        while rt.has_work and steps < 2000:
            rt.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got = [r.out_tokens for r in reqs]
        log(f"[{tag}] {'overlapped' if overlap else 'synchronous'}: "
            f"{rt.migrations} migrations (starved replica: preemptions "
            f"{starved.stats.preemptions}, spilled "
            f"{starved.stats.kv_spill_pages} pages; donor took "
            f"{donor.stats.migrated_in}); streams "
            f"{'bit-equal to' if got == want else 'DIFFER from'} one "
            f"resident replica's; wall {wall:.2f} s (one replica "
            f"{res_wall:.2f} s)")
        if rt.migrations <= 0 or got != want or not all(r.done for r in reqs):
            raise AssertionError(f"[{tag}] migrated != one replica")
        for c in (starved, donor):
            if c.allocator.available != c.num_pages - 1:
                raise AssertionError(f"[{tag}] pages leaked")
        del rt, cores, starved, donor
    t0 = _lap(tag, "router runs", t0)
    i = max(range(len(prompts)), key=lambda j: len(prompts[j]))
    a, b = _a5_engine(cfg, params), _a5_engine(cfg, params)
    a.add_request(Request(rid=i, prompt=list(prompts[i]), max_new_tokens=32))
    for _ in range(5):
        a.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    snap = a.snapshot_slot(i)
    t_snap = time.perf_counter() - t1
    t1 = time.perf_counter()
    data = snap.to_bytes()
    t_enc = time.perf_counter() - t1
    t1 = time.perf_counter()
    back = SlotSnapshot.from_bytes(data, expect_family="dense",
                                   expect_page_size=16)
    t_dec = time.perf_counter() - t1
    if not all(torch.equal(x, y) for p, q in zip(snap.pages, back.pages)
               for x, y in zip(p, q)) or len(back.pages) != len(snap.pages):
        raise AssertionError(f"[{tag}] a snapshot's bytes decode to other "
                             f"pages")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    b.inject_slot(back)
    torch.cuda.synchronize()
    t_inj = time.perf_counter() - t1
    b.run()
    if back.req.out_tokens != want[i]:
        raise AssertionError(f"[{tag}] the injected request's stream "
                             f"differs")
    log(f"[{tag}] a {len(prompts[i])}-token request after 5 steps "
        f"({back.slot_len} tokens, {back.n_pages} pages): snapshot "
        f"{len(data)} bytes ({len(data) / 2**20:.1f} MiB); snapshot "
        f"{t_snap * 1e3:.1f} ms, to_bytes {t_enc * 1e3:.1f} ms, from_bytes "
        f"{t_dec * 1e3:.1f} ms, inject {t_inj * 1e3:.1f} ms (synchronized); "
        f"pages bit-equal after the bytes, and the injected stream equals "
        f"the unmigrated one, on {smi}")
    del a, b, snap, back, data
    _drop_full(torch, "llama2-7b")
    _lap(tag, "snapshot and inject", t0)

FLEET_CKPT = 8        # the JAX router's checkpoint_every default

FLEET_KILL_STEP = 10
WATCHDOG_STEPS = (3, 7)


def _fleet_reqs(prompts, max_new: int = 32):
    """The serve trace as fleet requests: odd rids sampled with pinned
    seeds, as tests/test_fleet.py's ``_reqs``."""
    from repro_torch.serving.core import Request
    from repro_torch.serving.scheduler import SamplingParams

    return [Request(rid=i, prompt=list(p), max_new_tokens=max_new,
                    sampling=(SamplingParams(temperature=0.9, top_k=20,
                                             seed=100 + i)
                              if i % 2 else None))
            for i, p in enumerate(prompts)]


def _timed_checkpoints(torch, fl) -> dict:
    """Wrap a loopback fleet's checkpoint path to time each periodic
    checkpoint: the workers' snapshots (``WorkerHost._checkpoint``, pages
    to host bytes), the persist (``save_checkpoint``) and the whole pass;
    the rest of the pass is the wire (encode, frame, decode)."""
    rec = {"total": [], "snap": [], "save": [], "bytes": []}
    run, persist = fl._checkpoint, fl._persist

    def timed_total():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        rec["total"].append(time.perf_counter() - t0)
        rec["bytes"].append(sum(len(b) for b in fl._ckpt.values()))

    def timed_save():
        t0 = time.perf_counter()
        persist()
        rec["save"].append(time.perf_counter() - t0)

    for w in fl.workers + fl._spares:
        host = w.transport.host
        snap = host._checkpoint

        def timed_snap(snap=snap):
            t0 = time.perf_counter()
            out = snap()
            rec["snap"].append(time.perf_counter() - t0)
            return out
        host._checkpoint = timed_snap
    fl._checkpoint, fl._persist = timed_total, timed_save
    return rec


def _drive_fleet(torch, fl, reqs, kill=None) -> float:
    """Submit, step to the end; ``kill(fl)`` after step FLEET_KILL_STEP.
    Returns the synchronized wall s; every request must finish."""
    for r in reqs:
        fl.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while fl.has_work and steps < 4000:
        fl.step()
        steps += 1
        if kill is not None and steps == FLEET_KILL_STEP:
            kill(fl)
    torch.cuda.synchronize()
    if not all(r.done for r in reqs):
        raise AssertionError(f"[serve_fleet] lost requests "
                             f"{[r.rid for r in reqs if not r.done]}")
    return time.perf_counter() - t0


def _fleet_gate(fl, reqs, want, tag: str, what: str) -> None:
    got = [r.out_tokens for r in reqs]
    f = fl.fleet
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"[{tag}] {what}: streams of rids {bad} "
                             f"differ from one undisturbed engine's")
    if f.workers_lost != 1 or f.failovers != 1 or f.requests_replayed < 1:
        raise AssertionError(f"[{tag}] {what}: workers_lost "
                             f"{f.workers_lost}, failovers {f.failovers}, "
                             f"requests_replayed {f.requests_replayed}")


def _ms(xs) -> str:
    return ("/".join(f"{x * 1e3:.1f}" for x in xs) if xs else "none")


def _watchdog_run(torch, eng, reqs) -> tuple[list, list, list]:
    """Step ``eng`` to its end, each step synchronized and timed; returns
    (streams, walls of flagged steps, walls of other decode steps)."""
    for r in reqs:
        eng.add_request(r)
    flagged, other = [], []
    while eng.has_work:
        before = (eng.stats.straggler_events, eng.stats.decode_steps,
                  eng.stats.prefills)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if eng.stats.straggler_events > before[0]:
            flagged.append(dt)
        elif (eng.stats.decode_steps > before[1]
              and eng.stats.prefills == before[2]):
            other.append(dt)
    return [r.out_tokens for r in reqs], flagged, other


def _watchdog_check(torch, cfg, params, prompts, max_new, tag, arch, smi):
    from repro_torch.serving.core import Request

    def reqs():
        return [Request(rid=i, prompt=list(p), max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
    fired = set()

    def watchdog(step, dt):
        if step in WATCHDOG_STEPS and step not in fired:
            fired.add(step)
            return True
        return False
    want, _, _ = _watchdog_run(torch, _a5_engine(cfg, params), reqs())
    eng = _a5_engine(cfg, params, watchdog=watchdog)
    got, flagged, other = _watchdog_run(torch, eng, reqs())
    extra = (statistics.mean(flagged) - statistics.median(other)) * 1e3
    log(f"[{tag}] watchdog over {arch} (sync loop, flags decode steps "
        f"{WATCHDOG_STEPS}): straggler_events "
        f"{eng.stats.straggler_events}, streams "
        f"{'bit-equal to' if got == want else 'DIFFER from'} the unwatched "
        f"run's; a flagged step {_ms(flagged)} ms against a median "
        f"unflagged step {statistics.median(other) * 1e3:.2f} ms: the "
        f"re-dispatch (state copied back + a second replay) ~{extra:.2f} ms, "
        f"on {smi}")
    if got != want or eng.stats.straggler_events != len(WATCHDOG_STEPS):
        raise AssertionError(f"[{tag}] watchdog re-dispatch over {arch} "
                             f"changed the streams or missed an event")


def phase_serve_fleet(torch, smi: str) -> None:
    """Fleet serving on the card.  llama2-7b W8A8 at full width (the
    loopback fleets, their one-engine reference and the sanitized engine
    cut to its first CUT_LAYERS layers), 4 slots a worker, max_seq 1024,
    page 16, the serve trace, 32 new tokens, odd rids sampled with pinned
    seeds.

    Gates: (1) a loopback fleet of 2 workers + 1 spare sharing one params
    dict, ``checkpoint_every=8``, worker 0 killed after step 10, synchronous
    and overlapped: no request lost, every stream equal to one undisturbed
    engine's, one worker lost, one failover, requests replayed, the spare
    promoted (the serving kernels counted over the synchronous run);
    (2) the watchdog flagging decode steps 3 and 7 of the synchronous loop,
    llama2-7b and zamba2-7b W8A8 (the Mamba state restored): the unwatched
    streams and two straggler events; (3) ``REPRO_SANITIZE=1``: an
    overlapped + tiered (65 hot pages) + prefix-cache engine equals the
    plain synchronous one with no report and the rails run; (4) 2 socket
    workers, each building llama2-7b from ("llama2-7b", seed 0) on the
    card, one SIGKILLed after step 10, no checkpoints (failover replays
    from the client's record): the parent's single engine's streams.  Prints seconds until a socket worker is ready, a
    checkpoint's bytes and ms, recovery s, tokens replayed, the fleet's
    tok/s with and without checkpoints against one engine, and the
    watchdog's re-dispatch ms."""
    import gc
    import os
    import signal

    from repro_torch import _sanitize, kernels
    from repro_torch.serving.fleet.router import FleetRouter

    tag = "serve_fleet"
    t0 = time.monotonic()
    cfg, params = _full_model(torch, "llama2-7b")
    prompts = _serve_trace(cfg)
    kw = dict(A5_ENG)
    fcfg, fparams = _cut_depth(cfg, params, CUT_LAYERS)
    log(f"[{tag}] the loopback fleets run llama2-7b's first {CUT_LAYERS} "
        f"of {cfg.n_layers} layers at full width")
    one = _a5_engine(fcfg, fparams)
    reqs = _fleet_reqs(prompts)
    for r in reqs:
        one.add_request(r)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    one.run()
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t1
    want = [r.out_tokens for r in reqs]
    n_tok = sum(len(w) for w in want)
    del one
    # the socket workers build the whole model: their reference
    full = _a5_engine(cfg, params)
    reqs = _fleet_reqs(prompts)
    for r in reqs:
        full.add_request(r)
    full.run()
    want_full = [r.out_tokens for r in reqs]
    del full
    t0 = _lap(tag, "one engine", t0)

    # (1) loopback fleets, a worker killed mid-decode
    def kill(fl):
        fl.workers[0].transport.kill()

    for overlap in (False, True):
        fl = FleetRouter.build_loopback(fcfg, fparams, workers=2, spares=1,
                                        checkpoint_every=FLEET_CKPT,
                                        overlap=overlap, **kw)
        rec = _timed_checkpoints(torch, fl)
        reqs = _fleet_reqs(prompts)
        if not overlap:
            kernels.reset_launch_counts()
        wall = _drive_fleet(torch, fl, reqs, kill)
        if not overlap:
            counts = kernels.launch_counts()
            log(f"[{tag}] loopback fleet launches: " + ", ".join(
                f"{k} {counts[k]}" for k in SERVING_KERNELS))
            missing = [k for k in ("int8_gemv", "int8_gemm_tc",
                                   "paged_decode_attention",
                                   "flash_attention") if not counts.get(k)]
            if missing:
                raise AssertionError(f"[{tag}] the fleet path launched no "
                                     f"{missing}")
        _fleet_gate(fl, reqs, want, tag,
                    "overlapped" if overlap else "synchronous")
        if fl.spares_left != 0:
            raise AssertionError(f"[{tag}] the spare was not promoted")
        f = fl.fleet
        mib = [b / 2**20 for b in rec["bytes"]]
        log(f"[{tag}] loopback {'overlapped' if overlap else 'synchronous'}"
            f" (2 workers + 1 spare, checkpoint every {FLEET_CKPT} steps, "
            f"worker 0 killed after step {FLEET_KILL_STEP}): 0 requests "
            f"lost, streams bit-equal to one engine's; workers_lost "
            f"{f.workers_lost}, failovers {f.failovers}, requests_replayed "
            f"{f.requests_replayed}, tokens_replayed {f.tokens_replayed}, "
            f"recovery_s {_ms(fl.recovery_s)} ms; checkpoints "
            f"{len(rec['total'])}: "
            f"{'/'.join(f'{m:.0f}' for m in mib)} MiB "
            f"({'/'.join(str(b) for b in rec['bytes'])} bytes), whole pass "
            f"{_ms(rec['total'])} ms, of which worker snapshots "
            f"{_ms(rec['snap'])} ms and save_checkpoint {_ms(rec['save'])}"
            f" ms (the rest: the wire); wall {wall:.2f} s, on {smi}")
        fl.close()
        del fl
    t0 = _lap(tag, "loopback kills", t0)

    # the fleet's throughput with and without checkpoints, undisturbed
    walls = {}
    for every in (FLEET_CKPT, 0):
        fl = FleetRouter.build_loopback(fcfg, fparams, workers=2, spares=0,
                                        checkpoint_every=every, **kw)
        reqs = _fleet_reqs(prompts)
        walls[every] = _drive_fleet(torch, fl, reqs)
        if [r.out_tokens for r in reqs] != want:
            raise AssertionError(f"[{tag}] undisturbed fleet streams differ")
        fl.close()
        del fl
    log(f"[{tag}] tok/s (8 requests x 32 tokens, prefill included, "
        f"synchronized wall): one engine {n_tok / one_wall:.1f} "
        f"({one_wall:.2f} s); loopback fleet of 2 workers checkpoint every "
        f"{FLEET_CKPT} steps {n_tok / walls[FLEET_CKPT]:.1f} "
        f"({walls[FLEET_CKPT]:.2f} s), without checkpoints "
        f"{n_tok / walls[0]:.1f} ({walls[0]:.2f} s), on {smi}")
    t0 = _lap(tag, "throughput", t0)

    # (2) the watchdog over llama2-7b
    _watchdog_check(torch, cfg, params, prompts, 16, tag, "llama2-7b", smi)

    # (3) the sanitizer rails over an overlapped + tiered + prefix engine
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        san = _sanitize.load()
        if san is None:
            raise AssertionError(f"[{tag}] REPRO_SANITIZE=1 loaded no "
                                 f"sanitizer (tools/analysis missing?)")
        san.reset_counters()
        eng = _a5_engine(fcfg, fparams, overlap=True, kv_tier="flash",
                         num_pages=TIER_PAGES, prefix_cache=True)
        reqs = _fleet_reqs(prompts)
        for r in reqs:
            eng.add_request(r)
        eng.run()
        got = [r.out_tokens for r in reqs]
        log(f"[{tag}] REPRO_SANITIZE=1, overlapped + tiered ({TIER_PAGES} "
            f"hot pages) + prefix cache: {san.check_count()} checks, "
            f"{san.report_count()} reports; spilled "
            f"{eng.stats.kv_spill_pages} pages; streams "
            f"{'bit-equal to' if got == want else 'DIFFER from'} the plain "
            f"synchronous engine's")
        if (san.report_count() != 0 or san.check_count() <= 0
                or got != want or not eng.stats.kv_spill_pages):
            raise AssertionError(f"[{tag}] the sanitized engine differs, "
                                 f"reported or did not spill")
        del eng
    finally:
        os.environ.pop("REPRO_SANITIZE", None)
    t0 = _lap(tag, "watchdog and sanitizer (llama2-7b)", t0)
    _drop_full(torch, "llama2-7b")
    gc.collect()
    torch.cuda.empty_cache()

    # (2) the watchdog over zamba2-7b: the Mamba state is restored
    hcfg, hparams = _full_model(torch, "zamba2-7b")
    _watchdog_check(torch, hcfg, hparams, _serve_trace(hcfg, 4), 16, tag,
                    "zamba2-7b", smi)
    del hparams
    _drop_full(torch, "zamba2-7b")
    t0 = _lap(tag, "watchdog (zamba2-7b)", t0)

    # (4) socket workers on the card; the parent holds no model now
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] parent before spawning: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    t1 = time.perf_counter()
    # no checkpoints here: with no spare and the survivor's slots full a
    # checkpoint could not be injected, so failover replays from the
    # client's record either way (the checkpoint's cost is the loopback's)
    fl = FleetRouter.build_socket(
        "llama2-7b", workers=2, spares=0, checkpoint_every=0,
        reduced=False, quant="w8a8", seed=0, max_batch=A5_ENG["max_batch"],
        max_seq=A5_ENG["max_seq"], page_size=A5_ENG["page_size"],
        eos_id=A5_ENG["eos_id"], device=A5_ENG["device"],
        startup_timeout_s=300.0,
        reply_timeout_s=300.0)
    ready = time.perf_counter() - t1
    try:
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True).stdout.strip()
        free, total = torch.cuda.mem_get_info()
        log(f"[{tag}] 2 socket workers ready {ready:.1f} s after the spawn "
            f"(started together; the kernel library built before); the "
            f"card holds {(total - free) / 2**30:.1f} GiB in use (parent "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved); "
            f"nvidia-smi compute apps: {apps.replace(chr(10), '; ')}")
        reqs = _fleet_reqs(prompts)
        pids = []

        def sigkill(fl):
            pids.append(fl.workers[0].transport.pid)
            os.kill(pids[0], signal.SIGKILL)
        wall = _drive_fleet(torch, fl, reqs, sigkill)
        got = [r.out_tokens for r in reqs]
        f = fl.fleet
        log(f"[{tag}] socket fleet (2 card workers, worker pid {pids[0]} "
            f"SIGKILLed after step {FLEET_KILL_STEP}): 0 requests lost, "
            f"streams {'bit-equal to' if got == want_full else 'DIFFER from'} "
            f"the parent's single engine's; workers_lost {f.workers_lost}, "
            f"failovers {f.failovers}, requests_replayed "
            f"{f.requests_replayed}, tokens_replayed {f.tokens_replayed}, "
            f"recovery_s {_ms(fl.recovery_s)} ms; wall {wall:.2f} s, on {smi}")
        if got != want_full or f.workers_lost != 1:
            raise AssertionError(f"[{tag}] the socket fleet's streams "
                                 f"differ or no worker was lost")
    finally:
        fl.close()
    _lap(tag, "socket fleet", t0)


_MARKS: list[tuple[str, float]] = []


# ---------------------------------------------------------------------------
# serve_wave: wave mode at full width
# ---------------------------------------------------------------------------

WAVE_NEW = 32
# (arch, max_seq, prompt cap, mode, full checks: overlapped, sampled and
# the CPU logits gate); whisper-small's max_seq is its published decoder
# context (448), its prompts cut to 128 tokens so a wave fits
WAVE_ARCHS = (("whisper-small", 448, 128, "auto", True),
              ("mamba2-130m", 1024, None, "auto", True),
              ("llama2-7b", 1024, None, "wave", False),
              ("zamba2-7b", 1024, None, "wave", False))
# the kernels each model's wave run must launch
WAVE_REQUIRED = {
    "whisper-small": ("flash_attention_bidir", "flash_attention",
                      "paged_decode_attention", "int8_gemv", "int8_gemm_tc"),
    "mamba2-130m": ("ssd_intra_chunk", "int8_gemv", "int8_gemm_tc"),
    "llama2-7b": ("flash_attention", "paged_decode_attention", "int8_gemv",
                  "int8_gemm_tc"),
    "zamba2-7b": ("flash_attention", "paged_decode_attention",
                  "ssd_intra_chunk", "int8_gemv", "int8_gemm_tc")}


def _wave_sampling(i: int):
    """Odd requests sampled (temperature 0.8, top-k 20, top-p 0.9, a pinned
    seed), even ones greedy."""
    from repro_torch.serving.scheduler import SamplingParams

    return (SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=900 + i)
            if i % 2 else None)


def _wave_run(torch, client, prompts, tag: str, what: str, sampling=None,
              eager=False) -> tuple[list, dict]:
    """``_overlap_streams`` with the wall clock, the engine's prefill and
    decode walls and its graph accounting checked: one replay a decode step
    (none eager), 2 dispatches a step synchronous, 1 overlapped."""
    core = client.router.cores[0]
    pre0, dec0 = core.stats.wall_prefill_s, core.stats.wall_decode_s
    n_pre0 = core.stats.prefills
    t0 = time.perf_counter()
    streams, run = _overlap_streams(torch, client, prompts, WAVE_NEW,
                                    sampling=sampling, eager=eager)
    run["wall"] = time.perf_counter() - t0
    run["prefill_ms"] = ((core.stats.wall_prefill_s - pre0) * 1e3
                         / max(core.stats.prefills - n_pre0, 1))
    run["step_ms"] = ((core.stats.wall_decode_s - dec0) * 1e3
                      / max(run["steps"], 1))
    want = 1 if core.overlap else 2
    if run["steps"] <= 0 or run["dispatches"] != want * run["steps"] \
            or run["replays"] != (0 if eager else run["steps"]):
        raise AssertionError(f"[{tag}] {what}: {run['dispatches']} "
                             f"dispatches and {run['replays']} replays over "
                             f"{run['steps']} decode steps")
    tokens = sum(len(t) for t, _ in streams)
    log(f"[{tag}] {what}: {tokens} tokens in {run['wall']:.3f} s = "
        f"{tokens / run['wall']:.1f} tok/s; prefill {run['prefill_ms']:.1f} "
        f"ms a wave, decode {run['step_ms']:.2f} ms a step "
        f"({'dispatch only, ' if core.overlap else ''}{run['steps']} steps, "
        f"{run['replays']} replays)")
    return streams, run


def _wave_first_tokens(torch, cfg, params, prompts, max_seq) -> list[int]:
    """The greedy first tokens of the first wave from a direct ``prefill``
    on the card (the engine's left padding, its zero frames)."""
    from repro_torch.models import model as M
    from repro_torch.serving.core import _batch_extras

    wave = prompts[:4]
    plen = max(len(p) for p in wave)
    toks = torch.zeros((4, plen), dtype=torch.int32)
    for i, p in enumerate(wave):
        toks[i, plen - len(p):] = torch.tensor(p, dtype=torch.int32)
    cache = M.init_cache(cfg, 4, max_seq, device="cuda")
    logits, _ = M.prefill(params, cfg, toks.cuda(), cache,
                          _batch_extras(cfg, 4, torch.device("cuda")))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: non-finite wave prefill logits")
    return [int(t) for t in torch.argmax(logits, -1)[:len(wave)]]


def _wave_cpu_gate(torch, cfg, params, prompt) -> None:
    """One row's wave prefill logits on the card against the CPU in bf16
    and in float32 (the same W8A8 weights, the engine's zero frames):
    within MODEL_RATIO x the CPU bf16 run's distance from float32."""
    from repro_torch.models import model as M

    t0 = time.monotonic()
    toks = torch.tensor([prompt], dtype=torch.int32)
    logits = {}
    runs = _to_runs(torch, _tree_to(torch, params, "cpu"), params)
    for name, (p, dev, dtype) in runs.items():
        cache = M.init_cache(cfg, 1, len(prompt), dtype=dtype, device=dev)
        ex = ({"frames": torch.zeros((1, cfg.encoder_seq, cfg.d_model),
                                     dtype=torch.bfloat16, device=dev)}
              if cfg.family == "audio" else None)
        lg, _ = M.prefill(p, cfg, toks.to(dev), cache, ex)
        logits[name] = [lg.float().cpu()]
    log(f"[serve_wave] {cfg.name} CPU gate: three prefills of "
        f"{len(prompt)} tokens in {time.monotonic() - t0:.1f} s")
    _ratio_gate(torch, f"{cfg.name} wave prefill", logits)


def phase_serve_wave(torch, smi: str) -> dict:
    """Wave mode at full width, W8A8, 4 slots, through launch/serve.py's
    build_client (``mode="auto"`` picks wave for whisper-small and
    mamba2-130m; llama2-7b and zamba2-7b are asked for it): the serve
    trace (whisper's prompts cut to 128), 32 new tokens.  Each model's
    first run, synchronous over graphs, is counted and must launch its
    kernels (whisper-small: B3's bidirectional mode among them); the same
    requests run eagerly give the same streams; the engine's first tokens
    equal a direct prefill's.  whisper-small and mamba2-130m also run
    overlapped (the same streams), sampled synchronous == overlapped, and
    their prefill logits pass the model phase's CPU gate.  Returns
    whisper-small's launch counts."""
    import gc

    from repro_torch.launch.serve import build_client
    from repro_torch.serving.client import ServingClient

    owned = None
    for arch, max_seq, cap, mode, full in WAVE_ARCHS:
        tag = f"serve_wave {arch}"
        t0 = time.monotonic()
        cfg, client = build_client(arch, reduced=False, quant="w8a8",
                                   max_batch=4, max_seq=max_seq, seed=0,
                                   mode=mode, device="cuda")
        core = client.router.cores[0]
        if core.mode != "wave":
            raise AssertionError(f"[{tag}] the engine is in {core.mode} mode")
        params = core.params
        torch.cuda.synchronize()
        log(f"[{tag}] full width W8A8 built in {time.monotonic() - t0:.1f} "
            f"s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
            f"on {smi}")
        prompts = [p[:cap] if cap else p for p in _serve_trace(cfg)]
        greedy, run = _wave_run(torch, client, prompts, tag, "sync, graphs")
        counts = run["counts"]
        log(f"[{tag}] launches {counts}")
        missing = [k for k in WAVE_REQUIRED[arch] if counts[k] <= 0]
        if missing:
            raise AssertionError(f"[{tag}] the wave path never launched "
                                 f"{missing}")
        _no_off_path(counts, tag)
        if arch == "whisper-small":
            owned = counts
        eager, _ = _wave_run(torch, client, prompts, tag, "sync, eager",
                             eager=True)
        if eager != greedy:
            raise AssertionError(f"[{tag}] graph replay != eager")
        # the graphs captured and the kernels loaded: the steady walls
        warm, _ = _wave_run(torch, client, prompts, tag, "sync, graphs, warm")
        if warm != greedy:
            raise AssertionError(f"[{tag}] a second graph run differs")
        first = _wave_first_tokens(torch, cfg, params, prompts, max_seq)
        if first != [t[0] for t, _ in greedy[:4]]:
            raise AssertionError(f"[{tag}] the engine's first tokens "
                                 f"{[t[0] for t, _ in greedy[:4]]} are not a "
                                 f"direct prefill's {first}")
        log(f"[{tag}] graph == eager on {len(greedy)} requests; first "
            f"tokens == a direct prefill's")
        if full:
            over = ServingClient(cfg, params, max_batch=4, max_seq=max_seq,
                                 eos_id=-1, overlap=True, device="cuda")
            ov, _ = _wave_run(torch, over, prompts, tag, "overlapped, graphs")
            if ov != greedy:
                raise AssertionError(f"[{tag}] overlapped != synchronous")
            s_sync, _ = _wave_run(torch, client, prompts, tag,
                                  "sampled, sync", sampling=_wave_sampling)
            s_ov, _ = _wave_run(torch, over, prompts, tag,
                                "sampled, overlapped", sampling=_wave_sampling)
            if s_sync != s_ov:
                raise AssertionError(f"[{tag}] sampled: overlapped != "
                                     f"synchronous")
            if all(a == b for a, b in zip(s_sync[1::2], greedy[1::2])):
                raise AssertionError(f"[{tag}] no sampled row left argmax")
            log(f"[{tag}] overlapped == synchronous, greedy and sampled")
            del over
            _wave_cpu_gate(torch, cfg, params, prompts[0][:64])
        del client, core, params
        gc.collect()
        torch.cuda.empty_cache()
    return owned


# ---------------------------------------------------------------------------
# serve_moe: the moe family at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
MOE_CPU_LAYERS = 2   # the CPU gate's depth (full width; the whole model is
                     # too large for a CPU run)


@contextlib.contextmanager
def _routes():
    """Record, for every ``models/moe.py::_route`` call inside the block,
    (the chosen experts [n, k], each row's k-th / (k+1)-th router logit
    gap [n]) on the host."""
    from repro_torch.models import moe

    seen, orig = [], moe._route

    def route(params, xt, cfg, e):
        topi, probs = orig(params, xt, cfg, e)
        logits = (xt.float() @ params["router"]["w"].float())[
            :, :cfg.n_experts]
        top = logits.sort(-1, descending=True).values
        seen.append((topi.cpu(), (top[:, cfg.top_k - 1]
                                  - top[:, cfg.top_k]).cpu()))
        return topi, probs

    moe._route = route
    try:
        yield seen
    finally:
        moe._route = orig


def _int8_as_f64(torch, tree):
    """``tree`` with every int8 leaf as float64 (the same values)."""
    if isinstance(tree, dict):
        return {k: _int8_as_f64(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_int8_as_f64(torch, v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.int8:
        return tree.to(torch.float64)
    return tree


def _cut_depth(cfg, params, n: int):
    """(cfg, params) cut to the first ``n`` layers at full width (mla_moe
    keeps its dense first layers): an earlier path's depth cut so the
    script stays inside its time limit."""
    return (dataclasses.replace(cfg, n_layers=n),
            {**params, "layers": params["layers"][:n - cfg.first_k_dense]})


def _cut_logits(torch, cfg, params, prompt, n_layers: int, record=None):
    """The model cut to its first ``n_layers`` layers at full width: one
    prompt's prefill and 3 teacher-forced decode steps, card bf16, CPU bf16
    and CPU float32 on the same weights (``_to_runs``).  Returns (logits per
    run, per run what the context manager ``record()`` yielded around its
    steps, None without one)."""
    import dataclasses

    from repro_torch.models import model as M

    cut = dataclasses.replace(cfg, n_layers=n_layers)
    # mla_moe keeps its dense first layers (``dense_layers``) in the cut
    card = {**params,
            "layers": params["layers"][:n_layers - cfg.first_k_dense]}
    cpu = _tree_to(torch, card, "cpu")
    # the CPU's plain int8 product runs in float64 and converts its
    # operands at every call: the layers' int8 weights are held as float64
    # once (the same integers, so the same products; both CPU runs share
    # them)
    for key in ("dense_layers", "layers"):
        if key in cpu:
            cpu[key] = _int8_as_f64(torch, cpu[key])
    runs = _to_runs(torch, cpu, card)
    logits, seen = {}, {}
    toks = torch.tensor([prompt], dtype=torch.int32)
    extra = _prefill_extras(torch, cfg, 1)[1]
    pages = -(-(len(prompt) + extra + 4) // 16)
    block = torch.arange(1, pages + 1, dtype=torch.int32)[None]
    for name, (p, dev, dtype) in runs.items():
        cache = M.init_paged_cache(cut, 1, 16 * pages, dtype=dtype,
                                   page_size=16, device=dev)
        cache["block"] = block.to(dev)
        ex = _prefill_extras(torch, cfg, 1, dev)[0]
        with record() if record else contextlib.nullcontext() as rec:
            lg, cache = M.prefill_into_slots(
                p, cut, toks.to(dev),
                torch.tensor([len(prompt) + extra]).to(dev), cache,
                torch.tensor([0]).to(dev), ex)
            logits[name] = [lg.float().cpu()]
            for i in range(3):   # teacher-forced with the CPU run's tokens
                tok = torch.argmax(logits["cpu"][i], -1).to(torch.int32)
                lg, cache = M.decode_step_paged(
                    p, cut, tok.to(dev), cache,
                    torch.tensor([True]).to(dev))
                logits[name].append(lg.float().cpu())
        seen[name] = rec
    return logits, seen


def _moe_cpu_gate(torch, cfg, params, prompt, tag: str) -> None:
    """The model phase's gate at full width, the depth cut to
    MOE_CPU_LAYERS layers (``_cut_logits``; mla_moe's dense first layer
    among them), within MODEL_RATIO.  Beside it, at each MoE layer, the
    smallest router k-th / (k+1)-th logit gap and the rows whose experts
    differ between the runs (a near-tie that flips an expert shows
    there)."""
    t0 = time.monotonic()
    logits, routes = _cut_logits(torch, cfg, params, prompt, MOE_CPU_LAYERS,
                                 _routes)
    log(f"[{tag}] CPU gate: {MOE_CPU_LAYERS} of {cfg.n_layers} layers at "
        f"full width, a {len(prompt)}-token prompt and 3 decode steps, three "
        f"runs in {time.monotonic() - t0:.1f} s")
    routed = MOE_CPU_LAYERS - cfg.first_k_dense
    for li in range(routed):
        calls = range(li, len(routes["f32"]), routed)
        gap = min(float(routes["f32"][c][1].min()) for c in calls)
        def flips(a, b):
            return sum(int((routes[a][c][0].sort(-1).values
                            != routes[b][c][0].sort(-1).values).any(-1)
                           .sum()) for c in calls)
        rows = sum(len(routes["f32"][c][0]) for c in calls)
        log(f"[{tag}] CPU gate, layer {li}: smallest router k-th / (k+1)-th "
            f"logit gap {gap:.3e} (float32 run) over {rows} rows; rows whose "
            f"experts differ: card vs float32 {flips('cuda', 'f32')}, CPU "
            f"bf16 vs float32 {flips('cpu', 'f32')}, card vs CPU bf16 "
            f"{flips('cuda', 'cpu')}")
    _ratio_gate(torch, f"{cfg.name} {MOE_CPU_LAYERS} layers", logits)


def _moe_admission(torch, cfg, params, prompts, tag: str) -> None:
    """A request admitted while three others decode gives its solo stream
    bit for bit: its rows meet other rows in every grouped GEMM (the
    kernel's row invariance at the real routing)."""
    from repro_torch.serving.client import ServingClient

    client = ServingClient(cfg, params, max_batch=4, max_seq=1024,
                           page_size=16, eos_id=-1, device="cuda")
    core = client.router.cores[0]
    solo = _streams(torch, client, [prompts[0]], 32)[0]
    others = [client.submit(p, max_new_tokens=32) for p in prompts[1:4]]
    for _ in range(5):
        client.pump()
    prefills = core.stats.prefills
    late = client.submit(prompts[0], max_new_tokens=32)
    client.run()
    torch.cuda.synchronize()
    if not all(h.finished for h in others):
        raise AssertionError(f"[{tag}] the decoding requests did not finish")
    if late.request.out_tokens != solo:
        raise AssertionError(f"[{tag}] a request admitted mid-stream differs "
                             f"from its solo stream")
    log(f"[{tag}] a {len(prompts[0])}-token request admitted after 5 steps "
        f"of 3 others ({core.stats.prefills - prefills} prefill group) == "
        f"its solo stream, 32 tokens bit for bit")


def _partial_hits(torch, cfg, params, tag: str) -> None:
    """A partial prefix hit (one-shot pages of a primer's first
    PREFIX_CACHED tokens, the suffix through the chunk path) against a
    cold one-shot run, on 3 prompts: the logits (``_partial_paths``) and
    the engines' streams bit for bit."""
    import numpy as np

    from repro_torch.serving.core import Request

    rng = np.random.RandomState(17)
    cands = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
             for n in rng.randint(PREFIX_CACHED + 20, 480, size=3)]
    primers = [c[:PREFIX_CACHED] + [(c[PREFIX_CACHED] + 1) % cfg.vocab_size]
               for c in cands]
    checks = [_partial_paths(torch, params, cfg, c, p, MARGIN_TOKENS)
              for c, p in zip(cands, primers)]
    log(f"[{tag}] partial hit (one-shot prefix of {PREFIX_CACHED} tokens + "
        f"chunked suffix) vs one-shot, per prompt (top-1 margin, max "
        f"|dlogit|) over {MARGIN_TOKENS} greedy tokens: "
        + ", ".join(f"({mg:.4f}, {dr:.4f})" for mg, dr, _ok in checks))
    if not all(ok and dr == 0.0 for _mg, dr, ok in checks):
        raise AssertionError(f"[{tag}] a partial hit's logits differ from "
                             f"the one-shot run's")
    cold_e = _a5_engine(cfg, params)
    warm_e = _a5_engine(cfg, params, prefix_cache=True)
    for i, (cand, primer) in enumerate(zip(cands, primers)):
        a = Request(rid=3 * i, prompt=list(cand), max_new_tokens=16)
        cold_e.add_request(a)
        cold_e.run()
        warm_e.add_request(Request(rid=3 * i + 1, prompt=primer,
                                   max_new_tokens=1))
        warm_e.run()
        hits = warm_e.stats.prefix_hits
        b = Request(rid=3 * i + 2, prompt=list(cand), max_new_tokens=16)
        warm_e.add_request(b)
        warm_e.run()
        if warm_e.stats.prefix_hits != hits + 1:
            raise AssertionError(f"[{tag}] prompt {i} was not a partial hit")
        if a.out_tokens != b.out_tokens:
            raise AssertionError(f"[{tag}] partial hit {i} differs from the "
                                 f"cold engine's stream")
    log(f"[{tag}] 3 partial hits == cold one-shot runs, logits and 16-token "
        f"streams bit for bit")


def phase_serve_moe(torch, smi: str) -> dict:
    """qwen2-moe-a2.7b at full width (24 layers, d_model 2048, 16 heads of
    128 with qkv bias, 60 routed experts padded to 64, top-4, 4 shared
    experts of 1,408, vocab 151,936), random weights from seed 0 built on
    the card by ``init_params``, W8A8 (the routed experts bf16, as in
    JAX), 4 slots, max_seq 1024, page 16, the serve trace.  Gates: the
    counted run launches the grouped GEMM, B1, B2 and B3 (the grouped GEMM
    through the decode graph, 3 launches a layer); graph == eager and
    overlapped == synchronous, greedy and sampled; ``--chunk-prefill 128``
    gives the one-shot logits and streams bit for bit; a request admitted
    mid-stream gives its solo stream; partial prefix hits equal cold runs;
    a wave-mode run's first tokens equal a direct prefill's; the CPU gate
    at 2 layers.  Prints decode tok/s and ms a step (sync, overlapped),
    prefill ms a group, the grouped GEMM's device ms a step and a group
    (the profiles), launches a step, peak memory."""
    import gc

    import numpy as np

    from repro_torch.serving.client import ServingClient
    from repro_torch.serving.scheduler import make_scheduler

    tag = "serve_moe"
    t0 = time.monotonic()
    counts, client = _serve_full(torch, MOE_ARCH, tag, smi,
                                 required=("grouped_gemm",),
                                 layers=CUT_LAYERS)
    core = client.router.cores[0]
    cfg, params = core.cfg, core.params
    per_step = core.graph._deltas["sync"].get("grouped_gemm", 0)
    log(f"[{tag}] grouped GEMM launches: {counts['grouped_gemm']} in the "
        f"counted run, {per_step} a decode step (captured in the graph; "
        f"{3 * cfg.n_layers} expected)")
    if per_step != 3 * cfg.n_layers:
        raise AssertionError(f"[{tag}] the decode graph holds {per_step} "
                             f"grouped GEMM launches")
    t0 = _lap(tag, "counted run", t0)
    kw = dict(max_batch=4, max_seq=1024, page_size=16, eos_id=-1,
              device="cuda")
    prompts = _serve_trace(cfg)
    olap = ServingClient(cfg, params, overlap=True, **kw)
    eager, r_e = _overlap_streams(torch, client, prompts, 32, eager=True)
    graph, r_g = _overlap_streams(torch, client, prompts, 32)
    over, r_o = _overlap_streams(torch, olap, prompts, 32)
    _check_graph_run(core, r_g, tag, "sync graph")
    _check_graph_run(olap.router.cores[0], r_o, tag, "overlap")
    if r_e["replays"] != 0 or graph != eager or over != eager:
        raise AssertionError(f"[{tag}] greedy: graph / overlapped differ "
                             f"from eager")

    s_sync, _ = _overlap_streams(torch, client, prompts, 32, _sampled)
    s_over, _ = _overlap_streams(torch, olap, prompts, 32, _sampled)
    if s_sync != s_over:
        raise AssertionError(f"[{tag}] sampled: overlapped != synchronous")
    drawn = sum(a != b for a, b in zip(s_sync[1::2], graph[1::2]))
    if drawn == 0:
        raise AssertionError(f"[{tag}] no sampled stream left its greedy one")
    log(f"[{tag}] graph == eager == overlapped on 8 greedy requests; sampled "
        f"synchronous == overlapped ({drawn} of 4 sampled streams left "
        f"greedy); grouped GEMM launches graph / overlapped / eager "
        f"{r_g['counts']['grouped_gemm']} / {r_o['counts']['grouped_gemm']} "
        f"/ {r_e['counts']['grouped_gemm']}")
    tprompts = [[int(t) for t in np.random.RandomState(3).randint(
        0, cfg.vocab_size, n)] for n in (200, 240, 280, 320)]
    walls = {mode: _decode_wall(torch, c, tprompts, 64)
             for mode, c in (("sync", client), ("overlapped", olap))}
    log(f"[{tag}] decode, 4 slots at 200-384 tokens: "
        + ", ".join(f"{mode} {w:.2f} ms a step = {4e3 / w:.1f} tok/s ({n} "
                    f"steps)" for mode, (w, n) in walls.items())
        + f" (synchronized clock around the decode loop) on {smi}")
    del olap
    t0 = _lap(tag, "graph, eager, overlapped, sampled, walls", t0)
    chunked = ServingClient(cfg, params, scheduler=make_scheduler(
        "fcfs", chunk_tokens=CHUNK_BUDGET), **kw)
    rng = np.random.RandomState(5)
    cands = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
             for n in rng.randint(140, 400, size=6)]
    _bit_equal_streams(
        torch, params, cfg, cands, MARGIN_TOKENS,
        {"one-shot": ("bf16", 0), "chunked": ("bf16", CHUNK_BUDGET)},
        (client, chunked), tag)
    del chunked
    prompt = [int(t) for t in np.random.RandomState(7).randint(
        0, cfg.vocab_size, 150)]
    _chunk_invariance(torch, params, cfg, prompt, (16, CHUNK_BUDGET, 150),
                      "bf16", tag)
    t0 = _lap(tag, "one-shot == chunked", t0)
    _moe_admission(torch, cfg, params, prompts, tag)
    _partial_hits(torch, cfg, params, tag)
    t0 = _lap(tag, "admission and partial hits", t0)
    wave = ServingClient(cfg, params, mode="wave", **kw)
    wgreedy, _ = _wave_run(torch, wave, prompts, tag, "wave mode, graphs")
    first = _wave_first_tokens(torch, cfg, params, prompts, 1024)
    if first != [t[0] for t, _ in wgreedy[:4]]:
        raise AssertionError(f"[{tag}] the wave engine's first tokens are not "
                             f"a direct prefill's")
    log(f"[{tag}] wave mode: first tokens == a direct prefill's")
    del wave
    t0 = _lap(tag, "wave mode", t0)
    phase_profile(torch, client, smi, tag)
    t0 = _lap(tag, "profiles", t0)
    _moe_cpu_gate(torch, cfg, params, prompts[0][:64], tag)
    _lap(tag, "CPU gate", t0)
    del client, core, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


DENSE_ARCHS = ("chatglm3-6b", "internlm2-20b", "llama2-70b",
               "command-r-plus-104b")
DENSE_CPU_LAYERS = 2   # the CPU gate's depth (full width)
# command-r-plus-104b's depth on one card: 64 layers of W8A8 are 100.7 GB
# (1.573 GB a layer) beside a 6.29 GB tied bf16 embedding, more than the
# card holds in any quantization the reference offers; its first
# COMMAND_R_LAYERS layers leave room for the build's one bf16 layer and
# its quantizing temporaries, the engines' pools and graphs and a prefill
# group's float32 FFN temporaries (at 44 the build peaked at 79.7 GB and
# the phase at 79.9 of the card's 85.0; each layer more adds 1.59)
COMMAND_R_LAYERS = 44


def _int8_elems(tree) -> int:
    if isinstance(tree, dict):
        return sum(_int8_elems(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_int8_elems(v) for v in tree)
    return tree.numel() if getattr(tree, "dtype", None) is not None \
        and str(tree.dtype) == "torch.int8" else 0


def _host_gb_available() -> float:
    """MemAvailable of /proc/meminfo in GB (the CPU gate's host memory)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def _dense_cpu_gate(torch, cfg, params, prompt, tag: str) -> None:
    """The model phase's gate at full width, the depth cut to
    DENSE_CPU_LAYERS layers (``_cut_logits``), within MODEL_RATIO."""
    f64 = 8 * sum(_int8_elems(lp) for lp in params["layers"][
        :DENSE_CPU_LAYERS])
    log(f"[{tag}] CPU gate: host MemAvailable {_host_gb_available():.1f} GB "
        f"before it; its layers' int8 weights as float64 take "
        f"{f64 / 1e9:.1f} GB, beside a float32 and a bf16 copy of the "
        f"{_tree_bytes(params['embed']) / 1e9:.2f} GB embedding")
    t0 = time.monotonic()
    logits, _ = _cut_logits(torch, cfg, params, prompt, DENSE_CPU_LAYERS)
    log(f"[{tag}] CPU gate: {DENSE_CPU_LAYERS} of {cfg.n_layers} layers at "
        f"full width, a {len(prompt)}-token prompt and 3 decode steps, three "
        f"runs in {time.monotonic() - t0:.1f} s")
    _ratio_gate(torch, f"{cfg.name} {DENSE_CPU_LAYERS} layers", logits)


def _serve_dense(torch, arch: str, smi: str, every_gate: bool,
                 layers: int = 0) -> None:
    """``arch`` at full width, W8A8, random weights from seed 0 built on
    the card by ``init_params`` and quantized there, through build_client:
    4 slots, max_seq 1024, page 16, the serve trace (``_serve_full``:
    counted, B1-B3 launched, the first token a direct prefill's).  B1 runs
    at the configuration's query group inside the decode graph (one launch
    a layer a step); graph == eager on the serve trace; with
    ``every_gate`` also overlapped == eager, sampled synchronous ==
    overlapped, ``--chunk-prefill 128`` giving the one-shot logits and
    streams bit for bit (the chunk kernel counted) and 3 partial prefix
    hits equal to cold runs.  Decode walls (sync, overlapped), the prefill
    and decode profiles, the CPU gate on DENSE_CPU_LAYERS layers; the
    resident weights and pools and the peak from the counted run to the
    phase's end against the card's memory; the model freed at the end."""
    import gc

    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving.client import ServingClient
    from repro_torch.serving.scheduler import make_scheduler

    tag = f"serve_dense {arch}"
    t0 = time.monotonic()
    counts, client = _serve_full(torch, arch, tag, smi, layers=layers)
    core = client.router.cores[0]
    cfg, params = core.cfg, core.params
    log(f"[{tag}] resident: weights {_tree_bytes(params) / 1e9:.2f} GB "
        f"({cfg.n_layers} layers), page pools "
        f"{_tree_bytes([core.cache[k] for k in ('k', 'v')]) / 1e9:.2f} GB "
        f"({core.num_pages} pages); "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB "
        f"on {smi}")
    per_step = core.graph._deltas["sync"].get("paged_decode_attention", 0)
    log(f"[{tag}] B1 at a query group of {cfg.n_heads // cfg.n_kv_heads} "
        f"({cfg.n_heads} heads over {cfg.n_kv_heads}, D {cfg.d_head}): "
        f"{counts['paged_decode_attention']} launches in the counted run, "
        f"{per_step} a decode step inside the decode graph ({cfg.n_layers} "
        f"expected)")
    if per_step != cfg.n_layers:
        raise AssertionError(f"[{tag}] the decode graph holds {per_step} B1 "
                             f"launches")
    t0 = _lap(tag, "counted run", t0)
    kw = dict(max_batch=4, max_seq=1024, page_size=16, eos_id=-1,
              device="cuda")
    prompts = _serve_trace(cfg)
    olap = ServingClient(cfg, params, overlap=True, **kw)
    eager, r_e = _overlap_streams(torch, client, prompts, 32, eager=True)
    graph, r_g = _overlap_streams(torch, client, prompts, 32)
    _check_graph_run(core, r_g, tag, "sync graph")
    if r_e["replays"] != 0 or graph != eager:
        raise AssertionError(f"[{tag}] greedy: graph differs from eager")
    what = "graph == eager"
    if every_gate:
        over, r_o = _overlap_streams(torch, olap, prompts, 32)
        _check_graph_run(olap.router.cores[0], r_o, tag, "overlap")
        if over != eager:
            raise AssertionError(f"[{tag}] greedy: overlapped differs from "
                                 f"eager")

        s_sync, _ = _overlap_streams(torch, client, prompts, 32, _sampled)
        s_over, _ = _overlap_streams(torch, olap, prompts, 32, _sampled)
        if s_sync != s_over:
            raise AssertionError(f"[{tag}] sampled: overlapped != "
                                 f"synchronous")
        drawn = sum(a != b for a, b in zip(s_sync[1::2], graph[1::2]))
        if drawn == 0:
            raise AssertionError(f"[{tag}] no sampled stream left its "
                                 f"greedy one")
        what += (f" == overlapped; sampled synchronous == overlapped "
                 f"({drawn} of 4 sampled streams left greedy)")
    log(f"[{tag}] {what} on the serve trace's 8 requests; B1 launches "
        f"graph / eager {r_g['counts']['paged_decode_attention']} / "
        f"{r_e['counts']['paged_decode_attention']}")
    tprompts = [[int(t) for t in np.random.RandomState(3).randint(
        0, cfg.vocab_size, n)] for n in (200, 240, 280, 320)]
    walls = {mode: _decode_wall(torch, c, tprompts, 64)
             for mode, c in (("sync", client), ("overlapped", olap))}
    log(f"[{tag}] decode, 4 slots at 200-384 tokens: "
        + ", ".join(f"{mode} {w:.2f} ms a step = {4e3 / w:.1f} tok/s ({n} "
                    f"steps)" for mode, (w, n) in walls.items())
        + f" (synchronized clock around the decode loop) on {smi}")
    del olap
    t0 = _lap(tag, "graph, eager, overlapped, walls", t0)
    if every_gate:
        chunked = ServingClient(cfg, params, scheduler=make_scheduler(
            "fcfs", chunk_tokens=CHUNK_BUDGET), **kw)
        rng = np.random.RandomState(5)
        cands = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
                 for n in rng.randint(140, 400, size=6)]
        kernels.reset_launch_counts()
        _bit_equal_streams(
            torch, params, cfg, cands, MARGIN_TOKENS,
            {"one-shot": ("bf16", 0), "chunked": ("bf16", CHUNK_BUDGET)},
            (client, chunked), tag)
        n_chunk = kernels.launch_counts()["paged_chunk_attention"]
        log(f"[{tag}] the chunk kernel at a query group of "
            f"{cfg.n_heads // cfg.n_kv_heads}: {n_chunk} launches in the "
            f"one-shot vs chunked comparison")
        if n_chunk <= 0:
            raise AssertionError(f"[{tag}] the chunked path never launched "
                                 f"the chunk kernel")
        del chunked
        _partial_hits(torch, cfg, params, tag)
        t0 = _lap(tag, "one-shot == chunked, partial hits", t0)
    phase_profile(torch, client, smi, tag)
    t0 = _lap(tag, "profiles", t0)
    log(f"[{tag}] peak memory from the counted run to the phase's end "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB "
        f"on {smi}")
    _dense_cpu_gate(torch, cfg, params, prompts[0][:64], tag)
    _lap(tag, "CPU gate", t0)
    del client, core, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_dense(torch, smi: str) -> None:
    """The dense configurations whose query groups B1 takes in two passes
    or that no other phase serves: chatglm3-6b (28 layers, d_model 4096,
    32 query heads over 2 kv heads, a group of 16, rotary on half of each
    head, q/k/v and FFN biases, vocab 65,024) with every gate, then
    internlm2-20b (48 layers, d_model 6144, 48 heads over 8, vocab 92,544)
    with the serve trace, graph == eager, the first token and the CPU
    gate; then the paper's llama2-70b (80 layers, d_model 8192, 64 heads
    over 8, d_ff 28,672, vocab 32,000; its first CUT_LAYERS) with
    internlm2-20b's gates;
    then the parallel-block command-r-plus-104b (d_model 12,288, 96 heads
    over 8, a group of 12, d_ff 33,792, a tied 256,000-row embedding; its
    first COMMAND_R_LAYERS of 64 layers, the deepest cut the card holds)
    with every gate; each freed before the next is built."""
    _serve_dense(torch, DENSE_ARCHS[0], smi, every_gate=True,
                 layers=CUT_LAYERS)
    _serve_dense(torch, DENSE_ARCHS[1], smi, every_gate=False,
                 layers=CUT_LAYERS)
    _serve_dense(torch, DENSE_ARCHS[2], smi, every_gate=False,
                 layers=CUT_LAYERS)
    _serve_dense(torch, DENSE_ARCHS[3], smi, every_gate=True,
                 layers=COMMAND_R_LAYERS)


# ---------------------------------------------------------------------------
# serve_mla: the mla_moe family at full width
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v2-lite-16b"


def _mla_int8(torch, client, cfg, params, prompts, kw, tag: str) -> dict:
    """int8 pools: the serve trace counted (the MLA kernel's int8 variant,
    neither its bf16 variant nor B1), overlapped == synchronous, and the
    bf16 engine's greedy streams on margin-checked prompts."""
    import numpy as np

    from repro_torch.serving.client import ServingClient

    c8 = ServingClient(cfg, params, kv_dtype="int8", **kw)
    o8 = ServingClient(cfg, params, kv_dtype="int8", overlap=True, **kw)
    sync, run = _overlap_streams(torch, c8, prompts, 32)
    _check_graph_run(c8.router.cores[0], run, tag, "int8 pools")
    counts = run["counts"]
    stray = [k for k in ("mla_decode_attention", "paged_decode_attention",
                         "paged_decode_attention_int8") if counts[k] > 0]
    if counts["mla_decode_attention_int8"] <= 0 or stray:
        raise AssertionError(f"[{tag}] int8 pools: launches {counts}")
    over, _ = _overlap_streams(torch, o8, prompts, 32)
    if over != sync:
        raise AssertionError(f"[{tag}] int8 pools: overlapped != sync")
    log(f"[{tag}] int8 pools: the serve trace with "
        f"{counts['mla_decode_attention_int8']} launches of the MLA "
        f"kernel's int8 variant; overlapped == synchronous")
    rng = np.random.RandomState(5)
    cands = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
             for n in rng.randint(140, 400, size=8)]
    _margin_checked_streams(torch, params, cfg, cands, MARGIN_TOKENS,
                            {"bf16": ("bf16", 0), "int8": ("int8", 0)},
                            (client, c8), tag)
    return counts


def _tier_and_moves(torch, cfg, params, prompts, smi: str,
                    tag: str) -> None:
    """The A5 gates over a family's pages (mla_moe's compressed rows,
    vlm's K/V with the vision rows first): tiered == resident (a 65-page
    hot pool under the serve trace's demand), a snapshot's bytes resumed
    on another engine == the unmigrated stream, and a resume hit == its
    cold run with no prefill."""
    from repro_torch.serving.core import Request, SlotSnapshot

    want, res_wall = _run_trace(torch, _a5_engine(cfg, params), prompts, 32,
                                tag)
    eng = _a5_engine(cfg, params, kv_tier="flash", num_pages=TIER_PAGES)
    got, wall = _run_trace(torch, eng, prompts, 32, tag)
    s = eng.stats
    log(f"[{tag}] tiered, {TIER_PAGES} hot pages of "
        f"{eng.kv_page_bytes / 2**10:.0f} KiB: {s.kv_spill_pages} pages "
        f"spilled, {s.kv_prefetch_pages} prefetched, {s.preemptions} "
        f"preemptions; streams {'equal' if got == want else 'DIFFER'} to "
        f"the resident engine's; wall {wall:.2f} s (resident "
        f"{res_wall:.2f} s) on {smi}")
    if got != want or not (s.kv_spill_pages > 0 and s.preemptions > 0) \
            or eng.allocator.available != TIER_PAGES - 1:
        raise AssertionError(f"[{tag}] tiered != resident, or no spill")
    del eng
    i = max(range(len(prompts)), key=lambda j: len(prompts[j]))
    a, b = _a5_engine(cfg, params), _a5_engine(cfg, params)
    a.add_request(Request(rid=i, prompt=list(prompts[i]), max_new_tokens=32))
    for _ in range(5):
        a.step()
    snap = a.snapshot_slot(i)
    data = snap.to_bytes()
    back = SlotSnapshot.from_bytes(data, expect_family=cfg.family,
                                   expect_page_size=16)
    if len(back.pages[0]) != 2 or not all(
            torch.equal(x, y) for p, q in zip(snap.pages, back.pages)
            for x, y in zip(p, q)):
        raise AssertionError(f"[{tag}] a snapshot's bytes decode to other "
                             f"pages")
    b.inject_slot(back)
    b.run()
    if back.req.out_tokens != want[i]:
        raise AssertionError(f"[{tag}] the migrated stream differs")
    log(f"[{tag}] a {len(prompts[i])}-token request migrated after 5 steps "
        f"({back.n_pages} pages of {cfg.family} rows, "
        f"{len(data) / 2**20:.2f} MiB of snapshot bytes) == its unmigrated "
        f"stream")
    del a, b
    warm = _a5_engine(cfg, params, prefix_cache=True)
    outs = []
    for rid in (0, 1):
        r = Request(rid=rid, prompt=list(prompts[0]), max_new_tokens=32)
        warm.add_request(r)
        prefills = warm.stats.prefills
        warm.run()
        outs.append((r.out_tokens, warm.stats.prefills - prefills))
    if warm.stats.prefix_hits != 1 or outs[1][1] != 0 \
            or outs[0][0] != want[0] or outs[1][0] != want[0]:
        raise AssertionError(f"[{tag}] resume hit: {warm.stats.prefix_hits} "
                             f"hits, {outs[1][1]} prefills; streams equal "
                             f"to cold: {[o == want[0] for o, _ in outs]}")
    log(f"[{tag}] a resubmitted prompt: a resume hit with no prefill, its "
        f"stream == the cold run's")


def phase_serve_mla(torch, smi: str) -> tuple[dict, dict]:
    """deepseek-v2-lite-16b at full width (27 layers, the first dense with
    d_ff 10944, d_model 2048, 16 heads, MLA with R 512, Dn 128, Dr 64, Dv
    128; 64 routed experts of 1,408 top-6 and 2 shared; vocab 102,400),
    random weights from seed 0 built on the card by ``init_params``, W8A8
    (the routed experts bf16, as in JAX), 4 slots, max_seq 1024, page 16,
    the serve trace.  Gates: the counted run launches B2, B3 (at the qk
    head of 192), the grouped GEMM and the MLA kernel (one a layer inside
    the decode graph) and not B1; graph == eager == overlapped, greedy,
    and sampled synchronous == overlapped; int8 pools (``_mla_int8``);
    tiered == resident, migrated == unmigrated, a resume hit == cold
    (``_tier_and_moves``); a wave run's first tokens == a direct
    prefill's; every MLA ticket buffer zero after the runs; the CPU gate
    on 2 layers.  Prints decode ms a step and tok/s (sync, overlapped),
    prefill ms a group, the profiles, peak memory.  Returns the launch
    counts of the bf16 and int8 runs."""
    import gc

    import numpy as np

    from repro_torch.kernels.mla_decode_attention import ops as mla_ops
    from repro_torch.serving.client import ServingClient

    tag = "serve_mla"
    t0 = time.monotonic()
    counts, client = _serve_full(torch, MLA_ARCH, tag, smi,
                                 serving=MLA_SERVING, layers=CUT_LAYERS)
    core = client.router.cores[0]
    cfg, params = core.cfg, core.params
    per_step = core.graph._deltas["sync"].get("mla_decode_attention", 0)
    log(f"[{tag}] MLA kernel launches: {counts['mla_decode_attention']} in "
        f"the counted run, {per_step} a decode step (captured in the graph; "
        f"{cfg.n_layers} expected); B1 {counts['paged_decode_attention']}")
    if per_step != cfg.n_layers or counts["paged_decode_attention"] \
            or counts["paged_decode_attention_int8"]:
        raise AssertionError(f"[{tag}] the decode graph holds {per_step} MLA "
                             f"launches, or B1 ran")
    t0 = _lap(tag, "counted run", t0)
    kw = dict(max_batch=4, max_seq=1024, page_size=16, eos_id=-1,
              device="cuda")
    prompts = _serve_trace(cfg)
    olap = ServingClient(cfg, params, overlap=True, **kw)
    eager, r_e = _overlap_streams(torch, client, prompts, 32, eager=True)
    graph, r_g = _overlap_streams(torch, client, prompts, 32)
    over, r_o = _overlap_streams(torch, olap, prompts, 32)
    _check_graph_run(core, r_g, tag, "sync graph")
    _check_graph_run(olap.router.cores[0], r_o, tag, "overlap")
    if r_e["replays"] != 0 or graph != eager or over != eager:
        raise AssertionError(f"[{tag}] greedy: graph / overlapped differ "
                             f"from eager")

    s_sync, _ = _overlap_streams(torch, client, prompts, 32, _sampled)
    s_over, _ = _overlap_streams(torch, olap, prompts, 32, _sampled)
    if s_sync != s_over:
        raise AssertionError(f"[{tag}] sampled: overlapped != synchronous")
    drawn = sum(a != b for a, b in zip(s_sync[1::2], graph[1::2]))
    if drawn == 0:
        raise AssertionError(f"[{tag}] no sampled stream left its greedy one")
    log(f"[{tag}] graph == eager == overlapped on 8 greedy requests; sampled "
        f"synchronous == overlapped ({drawn} of 4 sampled streams left "
        f"greedy); MLA kernel launches graph / overlapped / eager "
        f"{r_g['counts']['mla_decode_attention']} / "
        f"{r_o['counts']['mla_decode_attention']} / "
        f"{r_e['counts']['mla_decode_attention']}")
    tprompts = [[int(t) for t in np.random.RandomState(3).randint(
        0, cfg.vocab_size, n)] for n in (200, 240, 280, 320)]
    walls = {mode: _decode_wall(torch, c, tprompts, 64)
             for mode, c in (("sync", client), ("overlapped", olap))}
    log(f"[{tag}] decode, 4 slots at 200-384 tokens: "
        + ", ".join(f"{mode} {w:.2f} ms a step = {4e3 / w:.1f} tok/s ({n} "
                    f"steps)" for mode, (w, n) in walls.items())
        + f" (synchronized clock around the decode loop) on {smi}")
    del olap
    t0 = _lap(tag, "graph, eager, overlapped, sampled, walls", t0)
    counts8 = _mla_int8(torch, client, cfg, params, prompts, kw, tag)
    gc.collect()
    t0 = _lap(tag, "int8 pools", t0)
    _tier_and_moves(torch, cfg, params, prompts, smi, tag)
    gc.collect()
    t0 = _lap(tag, "tiered, migrated, resume hit", t0)
    wave = ServingClient(cfg, params, mode="wave", **kw)
    wgreedy, run = _wave_run(torch, wave, prompts, tag, "wave mode, graphs")
    first = _wave_first_tokens(torch, cfg, params, prompts, 1024)
    if first != [t[0] for t, _ in wgreedy[:4]] \
            or run["counts"]["mla_decode_attention"] <= 0:
        raise AssertionError(f"[{tag}] the wave engine's first tokens are not "
                             f"a direct prefill's, or it ran no MLA kernel")
    log(f"[{tag}] wave mode: first tokens == a direct prefill's; the MLA "
        f"kernel over the contiguous cache "
        f"{run['counts']['mla_decode_attention']} launches")
    del wave
    t0 = _lap(tag, "wave mode", t0)
    rows, steps = phase_profile(torch, client, smi, tag)
    mla = [r for r in rows if "mla_decode_" in r[1]]
    launches = sum(r[2] for r in mla) / steps
    log(f"[{tag}] the MLA kernel in the decode profile: {launches:g} device "
        f"launches a step ({cfg.n_layers} layers), "
        f"{sum(r[0] for r in mla) / 1e3 / steps:.4f} device ms a step "
        f"({'; '.join(r[1][:60] for r in mla)}) on {smi}")
    if launches != cfg.n_layers or any(
            "mla_decode_attention_kernel" not in r[1] for r in mla):
        raise AssertionError(f"[{tag}] the decode step launches {launches:g} "
                             f"MLA device kernels, not one a layer")
    t0 = _lap(tag, "profiles", t0)
    # a ticket left above 0 would make every later launch that shares its
    # buffer skip the merge
    torch.cuda.synchronize()
    stuck = [k for k, t in mla_ops._TICKETS.items() if bool(t.any())]
    log(f"[{tag}] the MLA kernel's ticket buffers after every run above: "
        f"{len(mla_ops._TICKETS)}, {len(stuck)} not zero")
    if stuck:
        raise AssertionError(f"[{tag}] MLA ticket buffers left non-zero: "
                             f"{stuck}")
    _moe_cpu_gate(torch, cfg, params, prompts[0][:64], tag)
    _lap(tag, "CPU gate", t0)
    del client, core, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, counts8


# ---------------------------------------------------------------------------
# serve_vlm: the vlm family at full width
# ---------------------------------------------------------------------------

VLM_ARCH = "qwen2-vl-72b"


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return 0 if tree is None else tree.numel() * tree.element_size()


def _smi_memory_total() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.total", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]


def _int8_margins(torch, cfg, params, client, tag: str):
    """The int8 pools' direct greedy path and the bf16 pools' on 8
    candidate prompts (``_paired_logits``, the bf16 path fed the int8
    path's tokens).  Returns (the prompts whose top-1 margins exceed
    MARGIN on both paths, the int8 path's tokens of them; of those, the
    prompts on which the bf16 path picks the same tokens, and the bf16
    engine ``client``'s streams of them)."""
    import numpy as np

    rng = np.random.RandomState(5)
    cands = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
             for n in rng.randint(140, 400, size=8)]
    toks = []
    margins, drifts, agree = _paired_logits(
        torch, params, cfg, cands, MARGIN_TOKENS,
        {"int8": ("int8", 0), "bf16": ("bf16", 0)}, toks)
    own = [i for i, mg in enumerate(margins) if mg > MARGIN]
    both = [i for i in own if agree[i]]
    log(f"[{tag}] int8 vs bf16 pools: per prompt (top-1 margin, max "
        f"|dlogit| between the paths, same tokens) over {MARGIN_TOKENS} "
        f"greedy tokens: "
        + ", ".join(f"({mg:.4f}, {dr:.4f}, {'y' if ok else 'n'})"
                    for mg, dr, ok in zip(margins, drifts, agree))
        + f"; {len(own)} of {len(cands)} above {MARGIN}, {len(both)} of "
          f"them with the same tokens on both paths")
    if len(own) < 2:
        raise AssertionError(f"[{tag}] fewer than 2 margin-checked prompts")
    chosen = [cands[i] for i in both]
    return ([cands[i] for i in own], [toks[i] for i in own], chosen,
            _streams(torch, client, chosen, MARGIN_TOKENS))


def _vlm_int8(torch, cfg, params, prompts, margins, kw, tag: str) -> dict:
    """int8 pools, one engine at a time: the serve trace's first group
    counted (B1's int8 variant, never its bf16 one); on ``_int8_margins``'s
    prompts the int8
    engine's greedy streams == the direct int8 path's tokens, and == the
    bf16 engine's streams where both paths keep their margins and tokens;
    then an overlapped int8 engine == the synchronous one."""
    import gc

    from repro_torch.serving.client import ServingClient

    own, own_toks, both, want = margins
    c8 = ServingClient(cfg, params, kv_dtype="int8", **kw)
    sync, run = _overlap_streams(torch, c8, prompts[:4], 32)
    _check_graph_run(c8.router.cores[0], run, tag, "int8 pools")
    counts = run["counts"]
    if counts["paged_decode_attention_int8"] <= 0 \
            or counts["paged_decode_attention"]:
        raise AssertionError(f"[{tag}] int8 pools: launches {counts}")
    _same_streams(own_toks, _streams(torch, c8, own, MARGIN_TOKENS),
                  len(own), MARGIN_TOKENS,
                  f"{tag} int8 engine vs the direct int8 path")
    if both:
        _same_streams(want, _streams(torch, c8, both, MARGIN_TOKENS),
                      len(both), MARGIN_TOKENS, f"{tag} bf16 vs int8 pools")
    del c8
    gc.collect()
    torch.cuda.empty_cache()
    o8 = ServingClient(cfg, params, kv_dtype="int8", overlap=True, **kw)
    over, _ = _overlap_streams(torch, o8, prompts[:4], 32)
    if over != sync:
        raise AssertionError(f"[{tag}] int8 pools: overlapped != sync")
    log(f"[{tag}] int8 pools: the serve trace's first 4 requests with "
        f"{counts['paged_decode_attention_int8']} launches of B1's int8 "
        f"variant; overlapped == synchronous")
    del o8
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_serve_vlm(torch, smi: str) -> tuple[dict, dict]:
    """qwen2-vl-72b at full width (its first VLM_LAYERS of 80 layers,
    d_model 8192, 64 query heads
    over 8 kv heads of 128, q/k/v and FFN biases, d_ff 29,568, vocab
    152,064, M-RoPE over 256 prepended vision embeddings, zeros as the
    engine feeds them), random weights from seed 0 built on the card layer
    by layer and quantized W8A8 as they are made, 4 slots, max_seq 1024,
    page 16, the serve trace (caches of 320-768 rows).  Gates: the counted
    run launches B1, B2 and B3, B1 once a layer a step inside the decode
    graph; graph == overlapped, greedy (== eager on the first group of 4),
    and sampled synchronous == overlapped (the first group); int8 pools
    (``_vlm_int8``);
    tiered == resident over the first 4 prompts, migrated == unmigrated, a
    resume hit == cold through the vision rows' sentinel keys
    (``_tier_and_moves``); a wave run's first tokens == a direct
    prefill's; the CPU gate on 2 layers at full width.  One engine
    is alive at a time beside the weights.  Prints the build's time and
    peak against the resident bytes, the run's peak against memory.total,
    decode ms a step and tok/s (sync, overlapped), prefill ms a group, the
    profiles.  Returns the launch counts of the bf16 and int8 runs."""
    import gc

    import numpy as np

    from repro_torch.serving.client import ServingClient

    tag = "serve_vlm"
    t0 = time.monotonic()
    counts, client = _serve_full(torch, VLM_ARCH, tag, smi,
                                 layers=VLM_LAYERS)
    core = client.router.cores[0]
    cfg, params = core.cfg, core.params
    weights = _tree_bytes(params)
    pools = _tree_bytes([core.cache[k] for k in ("k", "v")])
    log(f"[{tag}] resident: weights {weights / 1e9:.2f} GB, page pools "
        f"{pools / 1e9:.2f} GB ({core.num_pages} pages); "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB "
        f"(nvidia-smi memory.total {_smi_memory_total()}) on {smi}")
    per_step = core.graph._deltas["sync"].get("paged_decode_attention", 0)
    log(f"[{tag}] B1 at H {cfg.n_heads} over Hkv {cfg.n_kv_heads}: "
        f"{counts['paged_decode_attention']} launches in the counted run, "
        f"{per_step} a decode step inside the decode graph ({cfg.n_layers} "
        f"expected); B2 GeMV {counts['int8_gemv']}, B2 GEMM "
        f"{counts['int8_gemm_tc']}, B3 {counts['flash_attention']}")
    if per_step != cfg.n_layers:
        raise AssertionError(f"[{tag}] the decode graph holds {per_step} B1 "
                             f"launches")
    t0 = _lap(tag, "counted run", t0)
    kw = dict(max_batch=4, max_seq=1024, page_size=16, eos_id=-1,
              device="cuda")
    prompts = _serve_trace(cfg)
    # eager over the first group of 4 only (an eager 72B step is ~0.5 s of
    # host launches); its streams are the graph run's first 4
    eager, r_e = _overlap_streams(torch, client, prompts[:4], 32, eager=True)
    graph, r_g = _overlap_streams(torch, client, prompts, 32)
    _check_graph_run(core, r_g, tag, "sync graph")
    if r_e["replays"] != 0 or graph[:4] != eager:
        raise AssertionError(f"[{tag}] greedy: graph differs from eager")
    s_sync, _ = _overlap_streams(torch, client, prompts[:4], 32, _sampled)
    tprompts = [[int(t) for t in np.random.RandomState(3).randint(
        0, cfg.vocab_size, n)] for n in (200, 240, 280, 320)]
    walls = {"sync": _decode_wall(torch, client, tprompts, 64)}
    margins = _int8_margins(torch, cfg, params, client, tag)
    t0 = _lap(tag, "graph, eager, sampled, sync wall, margins", t0)
    rows, steps = phase_profile(torch, client, smi, tag)
    b1 = [r for r in rows if "paged_decode_attention" in r[1]]
    gemv = [r for r in rows if "int8_gemv" in r[1]]
    total = sum(r[0] for r in rows)
    log(f"[{tag}] decode step: B1 {sum(r[0] for r in b1) / 1e3 / steps:.4f} "
        f"device ms, B2's GeMV {sum(r[0] for r in gemv) / 1e3 / steps:.3f} "
        f"({100 * sum(r[0] for r in gemv) / max(total, 1e-9):.1f}% of "
        f"{total / 1e3 / steps:.3f}) on {smi}")
    t0 = _lap(tag, "profiles", t0)
    _dense_cpu_gate(torch, cfg, params, prompts[0][:16], tag)
    t0 = _lap(tag, "CPU gate", t0)
    del client, core
    gc.collect()
    torch.cuda.empty_cache()
    olap = ServingClient(cfg, params, overlap=True, **kw)
    over, r_o = _overlap_streams(torch, olap, prompts, 32)
    _check_graph_run(olap.router.cores[0], r_o, tag, "overlap")
    if over != graph:
        raise AssertionError(f"[{tag}] greedy: overlapped differs from the "
                             f"graph run")
    s_over, _ = _overlap_streams(torch, olap, prompts[:4], 32, _sampled)
    if s_sync != s_over:
        raise AssertionError(f"[{tag}] sampled: overlapped != synchronous")
    drawn = sum(a != b for a, b in zip(s_sync[1::2], graph[1:4:2]))
    if drawn == 0:
        raise AssertionError(f"[{tag}] no sampled stream left its greedy one")
    walls["overlapped"] = _decode_wall(torch, olap, tprompts, 64)
    log(f"[{tag}] graph == overlapped on 8 greedy requests, == eager on the "
        f"first 4; sampled synchronous == overlapped on the first 4 ({drawn} "
        f"of 2 sampled streams left greedy); B1 launches graph / overlapped "
        f"/ eager "
        f"{r_g['counts']['paged_decode_attention']} / "
        f"{r_o['counts']['paged_decode_attention']} / "
        f"{r_e['counts']['paged_decode_attention']}")
    log(f"[{tag}] decode, 4 slots at 456-640 rows (256 vision rows each): "
        + ", ".join(f"{mode} {w:.2f} ms a step = {4e3 / w:.1f} tok/s ({n} "
                    f"steps)" for mode, (w, n) in walls.items())
        + f" (synchronized clock around the decode loop) on {smi}")
    del olap
    gc.collect()
    torch.cuda.empty_cache()
    t0 = _lap(tag, "overlapped, sampled, overlapped wall", t0)
    counts8 = _vlm_int8(torch, cfg, params, prompts, margins, kw, tag)
    t0 = _lap(tag, "int8 pools", t0)
    # the first 4 prompts: ~150 pages of demand over the 65-page pool
    _tier_and_moves(torch, cfg, params, prompts[:4], smi, tag)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = _lap(tag, "tiered, migrated, resume hit", t0)
    wave = ServingClient(cfg, params, mode="wave", **kw)
    wgreedy, run = _wave_run(torch, wave, prompts, tag, "wave mode, graphs")
    del wave
    gc.collect()
    torch.cuda.empty_cache()
    first = _wave_first_tokens(torch, cfg, params, prompts, 1024)
    if first != [t[0] for t, _ in wgreedy[:4]] \
            or run["counts"]["paged_decode_attention"] <= 0:
        raise AssertionError(f"[{tag}] the wave engine's first tokens are not "
                             f"a direct prefill's, or it ran no B1")
    log(f"[{tag}] wave mode: first tokens == a direct prefill's; B1 over the "
        f"contiguous cache {run['counts']['paged_decode_attention']} "
        f"launches")
    log(f"[{tag}] peak memory over the phase "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB "
        f"on {smi}")
    _lap(tag, "wave mode", t0)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, counts8


def _mark(name: str) -> None:
    """Log the time since the previous mark (the phase before ``name``)."""
    now = time.monotonic()
    if _MARKS:
        prev, t0 = _MARKS[-1]
        log(f"[time] {prev}: {now - t0:.1f} s")
    _MARKS.append((name, now))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="card,build,kernels,model,serve,profile,hybrid,"
                            "serve_w4a16,serve_hybrid,serve_hybrid_w4a16,"
                            "serve_overlap,serve_chunked,serve_int8kv,"
                            "serve_tiered,serve_prefix,serve_migrate,"
                            "serve_fleet,serve_wave,serve_moe,"
                            "serve_dense,serve_mla,serve_vlm")
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
    t_start = time.monotonic()
    _mark("build")
    if "build" in phases:
        phase_build()
    results = {name: {} for name in SOURCES}
    _mark("kernels")
    if "kernels" in phases:
        phase_kernels(torch, results)
    _mark("model")
    if "model" in phases:
        phase_model(torch)
    # launch counts are read only around each owning phase's run
    counts: dict[str, dict] = {}
    _mark("serve")
    if "serve" in phases:
        counts["serve"], client = phase_serve(torch, smi_line)
        if "profile" in phases:
            phase_profile(torch, client, smi_line)
        del client
        __import__("gc").collect()
        torch.cuda.empty_cache()
    _mark("hybrid")
    if "hybrid" in phases:
        counts["hybrid"] = phase_hybrid(torch)
    _mark("serve_w4a16")
    if "serve_w4a16" in phases:
        counts["serve_w4a16"] = phase_serve_w4a16(torch)
    _mark("serve_hybrid")
    if "serve_hybrid" in phases:
        counts["serve_hybrid"] = phase_serve_hybrid(torch, smi_line)
    _mark("serve_hybrid_w4a16")
    if "serve_hybrid_w4a16" in phases:
        counts["serve_hybrid_w4a16"] = phase_serve_hybrid_w4a16(torch,
                                                                smi_line)
    _mark("serve_overlap")
    if "serve_overlap" in phases:
        phase_serve_overlap(torch, smi_line)
    _mark("serve_chunked")
    if "serve_chunked" in phases:
        counts["serve_chunked"] = phase_serve_chunked(torch, smi_line)
    _mark("serve_int8kv")
    if "serve_int8kv" in phases:
        counts["serve_int8kv"], counts["serve_int8kv_chunked"] = \
            phase_serve_int8kv(torch, smi_line)
    _mark("serve_tiered")
    if "serve_tiered" in phases:
        phase_serve_tiered(torch, smi_line)
    _mark("serve_prefix")
    if "serve_prefix" in phases:
        phase_serve_prefix(torch, smi_line)
    _mark("serve_migrate")
    if "serve_migrate" in phases:
        phase_serve_migrate(torch, smi_line)
    _mark("serve_fleet")
    if "serve_fleet" in phases:
        phase_serve_fleet(torch, smi_line)
    _mark("serve_wave")
    if "serve_wave" in phases:
        counts["serve_wave"] = phase_serve_wave(torch, smi_line)
    _mark("serve_moe")
    if "serve_moe" in phases:
        counts["serve_moe"] = phase_serve_moe(torch, smi_line)
    _mark("serve_dense")
    if "serve_dense" in phases:
        # command-r-plus-104b's build leaves ~6 GB of the card beside its
        # weights while each layer's float temporaries come and go:
        # expandable segments map freed memory again whatever blocks it
        # was split into (4.7 GiB sat reserved in splinters when it ran out
        # of memory without them).  Set from this phase on only: it slows
        # the allocation churn of the earlier ones (serve_chunked's
        # one-shot == chunked check took 45% longer under it)
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
        phase_serve_dense(torch, smi_line)
    _mark("serve_mla")
    if "serve_mla" in phases:
        counts["serve_mla"], counts["serve_mla_int8"] = phase_serve_mla(
            torch, smi_line)
    _mark("serve_vlm")
    if "serve_vlm" in phases:
        counts["serve_vlm"], counts["serve_vlm_int8"] = phase_serve_vlm(
            torch, smi_line)
    _mark("end")
    log(f"[time] phases {args.phases} took "
        f"{time.monotonic() - t_start:.0f} s after the card check")
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
