"""Fig-10 style study of the port: model-output fidelity against the NAND
bit-error rate, with and without the on-die outlier ECC.

Twin of the JAX package's ``examples/ecc_resilience.py``: the model is
quantized to W8A8; every int8 leaf is cut into 16 KB pages, bit-flipped at
the given BER and, with ECC, protected by its sidecar (itself flipped) and
decoded (the B5 kernel on the card); ``forward`` then runs the corrupted
model on 4 x 24 random tokens, and the top-1 agreement with the clean
model's logits is reported.  The page flips are drawn from the same
generator state with and without ECC, so the two columns see the same
corrupted weights.

  python src/repro_torch/examples/ecc_resilience.py               # card
  python src/repro_torch/examples/ecc_resilience.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

if __package__ in (None, ""):  # run as a script: put src/ on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import torch  # noqa: E402

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import ecc  # noqa: E402
from repro_torch.core.hybrid_gemv import _from_pages, _to_pages  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.ecc_decode.ops import ecc_decode  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.quant.convert import quantize_params  # noqa: E402

BERS = (1e-5, 1e-4, 2e-4, 8e-4, 2e-3)
BATCH, SEQ = 4, 24   # the tokens the JAX example feeds forward


def corrupt_tree(tree, ber: float, gen_pages: torch.Generator,
                 gen_ecc: torch.Generator | None = None):
    """Bit-flip every int8 leaf; with ``gen_ecc`` protect each page with
    the ECC (the sidecar flipped too, from ``gen_ecc``) and decode it.
    Leaves are handled one at a time, so the scratch is one matrix's."""
    if isinstance(tree, dict):
        return {k: corrupt_tree(v, ber, gen_pages, gen_ecc)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [corrupt_tree(v, ber, gen_pages, gen_ecc) for v in tree]
    if not isinstance(tree, torch.Tensor) or tree.dtype != torch.int8:
        return tree
    pages = _to_pages(tree)
    noisy = ecc.inject_bitflips(pages, ber, gen_pages)
    if gen_ecc is not None:
        code = ecc.inject_ecc_bitflips(ecc.encode_pages(pages), ber, gen_ecc)
        noisy = ecc_decode(noisy, code)
    return _from_pages(noisy, tuple(tree.shape))


def run(arch: str = "smollm-360m", reduced: bool = True,
        device: str = "cuda", seed: int = 0, bers=BERS,
        dtype: torch.dtype = torch.float32
        ) -> list[tuple[float, float, float]]:
    """[(ber, top-1 agreement with ECC, without ECC)] over ``bers``; the
    float weights in ``dtype`` (float32 as the JAX example, bf16 as the
    engine serves them)."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    qparams = quantize_params(model_lib.init_params(
        cfg, seed=seed, max_seq=64, device=dev, dtype=dtype),
        consume=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen,
                         device=dev)
    clean_top1 = model_lib.forward(qparams, cfg, toks).argmax(-1)
    rows = []
    for i, ber in enumerate(bers):
        agree = {}
        for with_ecc in (True, False):
            gen_pages = torch.Generator(device=dev)
            gen_pages.manual_seed(seed * 1000 + i + 1)
            gen_ecc = None
            if with_ecc:
                gen_ecc = torch.Generator(device=dev)
                gen_ecc.manual_seed(seed * 1000 + i + 501)
            noisy = corrupt_tree(qparams, ber, gen_pages, gen_ecc)
            top1 = model_lib.forward(noisy, cfg, toks).argmax(-1)
            agree[with_ecc] = float((top1 == clean_top1).float().mean())
            del noisy
        rows.append((ber, agree[True], agree[False]))
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rows = run(args.arch, bool(args.reduced), args.device, args.seed)
    print(f"{'BER':>8} | {'top1 agree (ECC)':>17} | {'top1 agree (raw)':>17}")
    for ber, a_ecc, a_raw in rows:
        print(f"{ber:8.0e} | {a_ecc:16.1%} | {a_raw:16.1%}")
    print("\n(paper Fig. 10: ECC holds 92-95% accuracy at 2e-4 where the "
          "unprotected model collapses)")


if __name__ == "__main__":
    main()
