"""Why the paged decode attention kernel before split-KV was slower at head
dim 112 than at 128: its K pass and V pass timed apart on the card.

    python3 src/repro_torch/kernels/diag_b1_passes.py

Builds ``csrc/diag/decode_attention_pr14.cu`` (that kernel's source, MHA,
with each pass switchable) with nvcc into ``build/diag/``, counts the
loads and float multiply-adds of each instantiation in its SASS
(``cuobjdump -sass``), and times it at the batch PERF.md's kernel table
uses (B 4, 32 heads, lengths 1024 / 545 / 17 / 0, pages of 16) for D 128,
D 112, and D 112 with its rows placed 256 bytes apart as D 128's are
(pools of [P, page, Hkv, 128], the first 112 elements used): both passes,
the K pass alone, the V pass alone.  Then the split-KV kernel of the
library at D 128 and 112, each of its two kernels apart.  Device time per
call from torch.profiler (the median of CUDA-event times beside it), with
nvidia-smi's name and power limit.  Needs a card and nvcc; prints
``[diag_b1]`` lines.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "diag",
                   "decode_attention_pr14.cu")
PASSES = {"K+V": 3, "K only": 1, "V only": 2}


def _build() -> ctypes.CDLL:
    from repro_torch.kernels import build

    out = os.path.join(ROOT, "build", "diag")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libdiagb1.so")
    res = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", lib, SRC,
         "-lcudart"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}")
    for line in res.stdout.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[diag_b1] ptxas: {line.strip()}", flush=True)
    _sass_counts(lib)
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.diag_decode_attention_pr14.argtypes = [p] * 6 + [i] * 7 + [
        ctypes.c_float, p]
    dll.diag_decode_attention_pr14.restype = i
    return dll


def _sass_counts(lib: str) -> None:
    """Per kernel instantiation: SASS instructions, 16-byte global loads
    (K rows), 2-byte global loads (V elements) and FFMAs."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("[diag_b1] cuobjdump not found: SASS not counted", flush=True)
        return
    sass = subprocess.run([tool, "-sass", lib], stdout=subprocess.PIPE,
                          text=True).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, code = func.partition("\n")
        m = re.search(r"Li(\d+)ELi1ELi(\d)ELi(\d+)E", name)
        if not m:
            continue
        ins = re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", code)
        ops = [i.split()[0] if not i.startswith("@") else i.split()[1]
               for i in ins if i.strip()]
        n = lambda pre: sum(o.startswith(pre) for o in ops)  # noqa: E731
        print(f"[diag_b1] SASS D={m.group(1)} passes={m.group(2)} "
              f"DS={m.group(3)}: {len(ops)} instructions, "
              f"{n('LDG.E.128')} LDG.128, {n('LDG.E.U16')} LDG.U16, "
              f"{n('FFMA')} FFMA", flush=True)


def _times(torch, fn, n_bufs: int, by_kernel: bool = False):
    """(device ms per call under torch.profiler, median event ms), and with
    ``by_kernel`` the device ms per call of each kernel by name."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    ev = []
    for i in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i % n_bufs)
        end.record()
        end.synchronize()
        ev.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(10):
            fn(i % n_bufs)
        torch.cuda.synchronize()
    parts = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3 / 10
             for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA")}
    out = (sum(parts.values()), statistics.median(ev))
    return out + (parts,) if by_kernel else out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("diag_b1_passes: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    dll = _build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, page, pps, n_bufs = 4, 32, 16, 64, 3
    lens = [1024, 545, 17, 0]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    n_pages = b * pps + 1
    block = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:b * pps]
             + 1).reshape(b, pps).to(torch.int32).contiguous()
    stream = build.stream_handle(dev)
    kv_bytes = sum(lens) * h * 2 * 2
    for d, dstride in ((128, 128), (112, 112), (112, 128)):
        pools = [tuple(torch.randn((n_pages, page, h, dstride), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(2)) for _ in range(n_bufs)]
        q = torch.randn((b, h, d), generator=gen, device=dev).to(
            torch.bfloat16)
        out = torch.empty_like(q)
        layout = f"D={d} rows {dstride * 2} bytes apart"

        def old(i, passes):
            st = dll.diag_decode_attention_pr14(
                q.data_ptr(), pools[i][0].data_ptr(), pools[i][1].data_ptr(),
                block.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, d,
                page, pps, dstride, passes, float(d ** -0.5), stream)
            if st != 0:
                raise RuntimeError(f"diag kernel failed to launch ({st})")

        old(0, 3)
        kp, vp = (p[..., :d].contiguous() for p in pools[0])
        ref = paged_decode_attention_ref(q, kp, vp, block, lengths)
        err = (out[:3].float() - ref[:3].float()).abs().max().item()
        print(f"[diag_b1] {layout}: the copy's output against the plain "
              f"version, max|err| {err:.3e}", flush=True)
        for tag, passes in PASSES.items():
            dev_ms, ev_ms = _times(torch, lambda i: old(i, passes), n_bufs)
            print(f"[diag_b1] before split-KV, {layout}, {tag}: device "
                  f"{dev_ms:.4f} ms ({d * kv_bytes / dev_ms / 1e6:.1f} GB/s "
                  f"of K/V), events {ev_ms:.4f} ms on {smi}", flush=True)
        if dstride == d:
            new = [(t[0][..., :d].contiguous(), t[1][..., :d].contiguous())
                   for t in pools]
            dev_ms, ev_ms, parts = _times(
                torch, lambda i: paged_decode_attention(
                    q, new[i][0], new[i][1], block, lengths), n_bufs, True)
            each = ", ".join(
                f"{re.sub(r'[(<].*', '', k.split('::')[-1])} {v:.4f} ms"
                for k, v in parts.items())
            print(f"[diag_b1] split-KV, {layout}: device {dev_ms:.4f} ms "
                  f"({d * kv_bytes / dev_ms / 1e6:.1f} GB/s of K/V; {each}), "
                  f"events {ev_ms:.4f} ms on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
