"""Whether B6 (the SSD intra-chunk term) gives the same bits as another
checkout's B6, on the card.

    python3 src/repro_torch/kernels/diag_b6_bits.py --other DIR

DIR is another checkout of the repository (for example an earlier commit
unpacked with ``git archive`` into a directory under ``build/``).  Its
``ssd_intra_chunk`` runs in a subprocess on seeded inputs (each checkout
builds its own kernels into its own ``build/``), this checkout's on the
same inputs, and the outputs are compared bit for bit at B6's shapes in
``chip_smoke.py``'s kernels phase: the timed zamba2-7b and mamba2-130m
prefills (B 4, S 512, Q 128), Q 8, two B/C groups, Q 64 with 22 heads and
Q 40 with N 24, bf16 inputs (the tensor-core kernel) and, at the reduced
Q 8 shape, float32 (the CUDA-core kernel).  Prints one ``[diag_b6]`` line
a shape and nvidia-smi's name and power limit; exits 1 if any output
differs.  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
# (B, S, H, G, P, N, chunk, dtype)
SHAPES = (("zamba2-7b", 4, 512, 112, 1, 64, 64, 128, "bf16"),
          ("mamba2-130m", 4, 512, 24, 1, 64, 128, 128, "bf16"),
          ("Q 8", 4, 8, 8, 1, 16, 16, 8, "bf16"),
          ("G 2", 2, 256, 16, 2, 32, 64, 64, "bf16"),
          ("Q 64, 22 heads", 4, 1024, 22, 1, 64, 64, 64, "bf16"),
          ("Q 40, N 24", 1, 80, 8, 1, 32, 24, 40, "bf16"),
          ("Q 8, float32", 4, 8, 8, 1, 16, 16, 8, "f32"))


def outputs(src: str) -> dict:
    """B6's outputs at SHAPES, on the card, from the ``repro_torch`` under
    ``src``; model-like inputs (log decays from softplus dt) from one
    seeded generator."""
    import torch

    sys.path.insert(0, src)
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for tag, b, s, h, g, p, n, chunk, dt in SHAPES:
        kind = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(kind)
        step = torch.nn.functional.softplus(
            torch.randn((b, s, h), generator=gen, device="cuda"))
        a = -torch.linspace(1.0, 16.0, h, device="cuda") * step
        bm, cm = (torch.randn((b, s, g, n), generator=gen, device="cuda")
                  .mul(0.5).to(kind) for _ in range(2))
        res[tag] = ssd_intra_chunk(x, a, bm, cm, chunk).cpu()
    torch.cuda.synchronize()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another checkout of the repository")
    ap.add_argument("--save", help=argparse.SUPPRESS)  # the subprocess's
    args = ap.parse_args(argv)
    import torch

    if args.save:
        torch.save(outputs(os.path.join(os.getcwd(), "src")), args.save)
        return 0
    if not args.other:
        ap.error("--other DIR is required")
    other = os.path.abspath(args.other)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        saved = os.path.join(tmp, "other.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--save",
                        saved], cwd=other, check=True)
        theirs = torch.load(saved)
    ours = outputs(os.path.join(ROOT, "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    bad = 0
    for tag, b, s, h, g, p, n, chunk, dt in SHAPES:
        out = ours[tag]
        diff = int((out.view(torch.int32)
                    != theirs[tag].view(torch.int32)).sum())
        bad += diff
        print(f"[diag_b6] {tag}: B={b} S={s} H={h} G={g} P={p} N={n} "
              f"Q={chunk} {dt}: "
              + ("bit-identical" if diff == 0 else f"{diff} outputs DIFFER")
              + f" to {other}'s B6, on {smi}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
