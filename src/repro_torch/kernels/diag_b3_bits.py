"""Whether B3 (the causal prefill flash attention) gives the same bits as
another checkout's B3, on the card.

    python3 src/repro_torch/kernels/diag_b3_bits.py --other DIR

DIR is another checkout of the repository (for example an earlier commit
unpacked with ``git archive`` into a directory under ``build/``).  Its
``flash_attention`` runs in a subprocess on seeded inputs (each checkout
builds its own kernels into its own ``build/``), this checkout's on the
same inputs, and the outputs are compared bit for bit at B3's shapes: the
serve trace's llama2-7b and zamba2-7b groups (B 4, S 512, D 128 and 112),
smollm-360m's GQA (15 heads on 5), a ragged S 200 with 8 heads on 2, the
reduced models' D 16, and one-shot prefills of 1,008 and 4 x 1,024 tokens.
Prints one ``[diag_b3]`` line a shape and nvidia-smi's name and power
limit; exits 1 if any output differs.  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
# (B, S, H, Hkv, D)
SHAPES = ((4, 512, 32, 32, 128), (4, 512, 32, 32, 112), (4, 512, 15, 5, 64),
          (2, 200, 8, 2, 128), (4, 32, 4, 4, 16), (1, 1008, 32, 32, 128),
          (4, 1024, 32, 32, 128))


def outputs(src: str) -> dict:
    """B3's outputs at SHAPES, on the card, from the ``repro_torch`` under
    ``src``; inputs from one seeded generator."""
    import torch

    sys.path.insert(0, src)
    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for b, s, h, hkv, d in SHAPES:
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (h, hkv, hkv))
        res[(b, s, h, hkv, d)] = flash_attention(q, k, v).cpu()
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
    for key, out in ours.items():
        n = int((out != theirs[key]).sum())
        bad += n
        b, s, h, hkv, d = key
        print(f"[diag_b3] B={b} S={s} H={h} Hkv={hkv} D={d}: "
              + ("bit-identical" if n == 0 else f"{n} outputs DIFFER")
              + f" to {other}'s B3, on {smi}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
