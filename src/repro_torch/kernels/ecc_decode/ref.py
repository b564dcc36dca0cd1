"""Plain PyTorch version of the ECC decode kernel (the kernel's oracle):
``core.ecc.decode_pages``, bit for bit the JAX ``decode_pages`` outside
colliding addresses, where it fixes "the last entry wins"."""

from repro_torch.core.ecc import decode_pages as ecc_decode_ref  # noqa: F401
