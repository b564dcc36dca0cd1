"""Hand-written Hopper kernels of the port, one folder per Pallas kernel
they replace (``ops.py`` wrapper, ``ref.py`` plain version), with the CUDA
sources under ``csrc/`` and the build in ``build.py``.

Each wrapper counts its launches in its module's ``LAUNCHES`` dict;
:func:`launch_counts` gathers them and :func:`reset_launch_counts` zeroes
them, so a run can show which kernels its main path went through.
"""

from __future__ import annotations


def _counters() -> list[dict]:
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.ecc_decode import ops as ecc_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.int8_pagegemv import ops as int8_ops
    from repro_torch.kernels.w4a16_gemv import ops as w4_ops

    return [int8_ops.LAUNCHES, decode_ops.LAUNCHES, flash_ops.LAUNCHES,
            w4_ops.LAUNCHES, ecc_ops.LAUNCHES]


def launch_counts() -> dict[str, int]:
    out: dict[str, int] = {}
    for c in _counters():
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _counters():
        for name in c:
            c[name] = 0
