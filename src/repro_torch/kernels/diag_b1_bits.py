"""Whether B1 (the paged decode attention) gives, at query groups of 1-8,
the bits it gave while it took groups of up to 8 only, on the card.

    python3 src/repro_torch/kernels/diag_b1_bits.py

Builds ``csrc/diag/decode_attention_groups8.cu`` (the kernel's source as it
was before groups above 8 ran in two passes; only its C entry renamed) with
nvcc into ``build/diag/``, then runs it and the library's
``paged_decode_attention`` on the same seeded inputs, over bf16 and int8
pools, and compares the outputs bit for bit: the head layouts of the
ported configurations with groups of 1-8 (llama2-7b, zamba2-7b's head dim
112, smollm-360m, internlm2-20b, whisper-small, the reduced models' D 16)
and groups 1 to 8 over 2 kv heads at D 128, at lengths that cross the
split edges.  Prints one ``[diag_b1_bits]`` line a case and nvidia-smi's
name and power limit; exits 1 if any output differs.  ``chip_smoke.py``'s
kernels phase runs the same comparison.  Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "diag",
                   "decode_attention_groups8.cu")
LIB = os.path.join(ROOT, "build", "diag", "libdiagb1groups8.so")
ENTRY = "diag_paged_decode_attention_groups8"
PAGE, PPS = 16, 64   # pages of 16 rows, 1,024 keys a slot
LENS = [1024, 545, 17, 0, 1, 63, 64, 65]
# (tag, H, Hkv, D): every group of 1-8 the ported configurations have, and
# each group of 1 to 8 over 2 kv heads
CASES = ([("llama2-7b", 32, 32, 128), ("zamba2-7b", 32, 32, 112),
          ("smollm-360m", 15, 5, 64), ("internlm2-20b", 48, 8, 128),
          ("whisper-small", 12, 12, 64), ("reduced", 4, 2, 16),
          ("D 32, group 8", 8, 1, 32)]
         + [(f"group {g}", 2 * g, 2, 128) for g in range(1, 9)])


def start_build() -> subprocess.Popen:
    """nvcc of the groups-of-8 kernel into ``LIB``, started (not waited
    for), so that it can run beside the library's build."""
    from repro_torch.kernels import build

    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    return subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", LIB, SRC,
         "-lcudart"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def load(proc: subprocess.Popen | None = None) -> ctypes.CDLL:
    """The groups-of-8 kernel's library, once ``proc`` (a
    :func:`start_build`, started here if None) has finished."""
    proc = proc or start_build()
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SRC}:\n{out}")
    dll = ctypes.CDLL(LIB)
    p, i = ctypes.c_void_p, ctypes.c_int
    getattr(dll, ENTRY).argtypes = [p] * 9 + [i] * 8 + [ctypes.c_float, p]
    getattr(dll, ENTRY).restype = i
    return dll


def groups8(dll: ctypes.CDLL, q, k_pages, v_pages, block, lengths):
    """The groups-of-8 kernel with ``paged_decode_attention``'s arguments
    (CUDA tensors, a group of at most 8)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.ops import _check_pools
    from repro_torch.kernels.decode_attention.ref import SPLIT

    k, v, ks, vs, int8 = _check_pools(q, k_pages, v_pages, ENTRY, 8)
    b, h, d = q.shape
    page, hkv = k.shape[1], k.shape[2]
    pps = block.shape[1]
    n_split = -(-pps * page // SPLIT)
    out = torch.empty_like(q)
    ws = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                     device=q.device)
    status = getattr(dll, ENTRY)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ks.data_ptr() if int8 else None, vs.data_ptr() if int8 else None,
        block.data_ptr(), lengths.data_ptr(), ws.data_ptr(), out.data_ptr(),
        b, h, hkv, d, page, pps, n_split, int(int8), float(d ** -0.5),
        build.stream_handle(q.device))
    if status != 0:
        raise RuntimeError(f"{ENTRY} failed to launch ({status})")
    return out


def compare(torch, dll: ctypes.CDLL, log=print, smi: str = "") -> int:
    """The library's B1 against the groups-of-8 kernel at every CASES
    layout over bf16 and int8 pools, bit for bit; one line a case.
    Returns the number of outputs that differ."""
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.models.attention import quantize_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    b = len(LENS)
    lengths = torch.tensor(LENS, dtype=torch.int32, device=dev)
    bad = 0
    for tag, h, hkv, d in CASES:
        n_pages = b * PPS + 1
        q, kp, vp = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((b, h, d), (n_pages, PAGE, hkv, d),
                                          (n_pages, PAGE, hkv, d)))
        block = (torch.randperm(n_pages - 1, generator=gen, device=dev)
                 + 1).reshape(b, PPS).to(torch.int32)
        for kv, pools in (("bf16", (kp, vp)),
                          ("int8", (quantize_rows(kp), quantize_rows(vp)))):
            ours = paged_decode_attention(q, *pools, block, lengths)
            theirs = groups8(dll, q, *pools, block, lengths)
            torch.cuda.synchronize()
            n = int((ours != theirs).sum())
            bad += n
            log(f"[diag_b1_bits] {tag} H={h} Hkv={hkv} D={d} {kv} pools, "
                f"lens {LENS}: "
                + ("bit-identical" if n == 0 else f"{n} outputs DIFFER")
                + f" to the groups-of-8 build{' on ' + smi if smi else ''}")
    return bad


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("diag_b1_bits: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    t0 = time.monotonic()
    proc = start_build()
    build.library()
    dll = load(proc)
    print(f"[diag_b1_bits] both builds in {time.monotonic() - t0:.1f} s",
          flush=True)
    return 1 if compare(torch, dll, smi=smi) else 0


if __name__ == "__main__":
    sys.exit(main())
