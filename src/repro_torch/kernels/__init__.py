"""Hand-written Hopper kernels of the port, one folder per Pallas kernel
they replace (``ops.py`` wrapper, ``ref.py`` plain version; two replace
jnp code that has no Pallas kernel: ``grouped_gemm`` ``jax.lax.ragged_dot``
and its gradient,
``mla_decode_attention`` the attention of ``_mla_absorbed_attend``), with
the CUDA sources under ``csrc/`` and the build in ``build.py``.

Each wrapper counts its launches in its module's ``LAUNCHES`` dict;
:func:`launch_counts` gathers them and :func:`reset_launch_counts` zeroes
them, so a run can show which kernels its main path went through.  The
grouped GEMM's module counts four: ``grouped_gemm`` (bf16, serving) and
the float32 training kernels ``grouped_gemm_f32``, ``grouped_gemm_f32_dx``
and ``grouped_gemm_f32_dw`` (``csrc/grouped_gemm_f32.cu``); the float32
attention pair's are ``flash_attention_f32``, ``flash_attention_f32_dkdv``
and ``flash_attention_f32_dq``.  A
replayed CUDA graph (``serving/graphs.py``) runs no wrapper code: it adds
the launches its capture recorded with :func:`add_launch_counts` on every
replay.
"""

from __future__ import annotations


def _counters() -> list[dict]:
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.ecc_decode import ops as ecc_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.grouped_gemm import ops as grouped_ops
    from repro_torch.kernels.int8_pagegemv import ops as int8_ops
    from repro_torch.kernels.mla_decode_attention import ops as mla_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.w4a16_gemv import ops as w4_ops

    return [int8_ops.LAUNCHES, decode_ops.LAUNCHES, flash_ops.LAUNCHES,
            w4_ops.LAUNCHES, ecc_ops.LAUNCHES, ssd_ops.LAUNCHES,
            grouped_ops.LAUNCHES, mla_ops.LAUNCHES]


def launch_counts() -> dict[str, int]:
    out: dict[str, int] = {}
    for c in _counters():
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _counters():
        for name in c:
            c[name] = 0


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (kernel name -> launches) to the counters."""
    for c in _counters():
        for name in c:
            c[name] += delta.get(name, 0)
