"""Wire codec + framing of the fleet protocol: the port's own copy of
``repro.serving.fleet.wire``, byte for byte the same format, so each side
decodes the other's frames and snapshots.

Everything a FleetRouter says to a worker — and everything that comes
back — is one *frame*::

    +-------+---------+-------+-------------------+----------------+
    | magic | version | flags | payload length u32 | payload bytes |
    |  2 B  |   1 B   |  1 B  |    big-endian      |               |
    +-------+---------+-------+-------------------+----------------+

and every payload is one *value* in a tagged self-describing binary
encoding (:func:`encode` / :func:`decode`): None / bool / int / float /
str / bytes / list / tuple / dict / array (a torch tensor or a numpy
ndarray: raw bytes plus the dtype name), plus the four serving dataclasses
(``Request``, ``SamplingParams``, ``RequestOutput``, ``SlotSnapshot``)
encoded as field-name → value maps, so a decoder can skip fields it
does not know about (forward compatibility: new fields go at the end,
defaulted).

:class:`FrameDecoder` is the incremental receive side: feed it byte
chunks exactly as ``recv`` produced them — partial headers, frames
split across reads, many frames in one read — and it yields complete
payloads.  A wrong magic, an unsupported version, or a payload length
past the cap raises :class:`ProtocolError` instead of hanging or
swallowing garbage.

Arrays decode to CPU torch tensors.  A bf16 tensor travels as the raw
bytes of its 16-bit pattern under the dtype name ``"bfloat16"`` (what the
JAX side writes for an ``ml_dtypes.bfloat16`` array) and decodes back to
a bf16 tensor through its uint16 view, as ``repro_torch.bridge`` carries
weights: no ``ml_dtypes`` is needed.

``snapshot_to_bytes`` / ``snapshot_from_bytes`` give ``SlotSnapshot``
its standalone byte format (used by the periodic failover checkpoints
as well as the transport): a versioned header carrying the geometry —
family, page_size, page dtype, page count — that a receiver can guard
on *before* decoding the body.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

MAGIC = b"\xf1\x37"          # frame magic ("fleet")
WIRE_VERSION = 1
# The frame cap: the u32 length field's limit.  The JAX package caps a
# frame at 256 MiB, below one full-width llama2-7b slot's snapshot (64
# pages of 8 MiB at 1,024 tokens) and a worker's checkpoint reply (every
# active slot, ~600 MiB on the serve trace), so a full-width fleet's
# checkpoint could not be framed; the bytes of a frame are unchanged.
MAX_PAYLOAD = (1 << 32) - 1
_HEADER = struct.Struct(">2sBBI")   # magic, version, flags, payload length
HEADER_SIZE = _HEADER.size

SNAP_MAGIC = b"KVSN"         # SlotSnapshot byte-format magic
SNAP_VERSION = 1


class ProtocolError(RuntimeError):
    """Malformed frame or payload: wrong magic, bad version, truncated or
    oversized data, unknown tag.  Never raised for well-formed messages
    the receiver merely dislikes — those are application errors."""


# The fields each serving dataclass puts on the wire, the JAX package's
# list: the port's dataclasses carry the same names in the same order, so
# each side decodes the other's bytes (a receiver skips fields it does not
# know).  A field added to a dataclass goes here too, last and defaulted.
WIRE_FIELDS = {
    "Request": (
        "rid", "prompt", "max_new_tokens", "priority", "arrival_s",
        "deadline_s", "session", "sampling", "temperature", "out_tokens",
        "done", "rejected", "finish_reason", "n_folded", "n_chunks",
        "n_preempted", "n_migrated", "t_submit", "t_admit",
        "t_first_token", "t_done",
    ),
    "SamplingParams": ("temperature", "top_k", "top_p", "seed"),
    "RequestOutput": (
        "rid", "token", "n_out", "finished", "finish_reason",
        "ttft_s", "latency_s", "sched",
    ),
    "SlotSnapshot": (
        "req", "slot_len", "last_token", "prefilling", "prefill_pos",
        "pages", "ssm", "page_size", "family", "prefix_keys",
    ),
}


# ----------------------------------------------------------------------
# value codec
# ----------------------------------------------------------------------
def _serving_types():
    # imported lazily: core imports this module from SlotSnapshot.to_bytes,
    # so a top-level import either way would be circular
    from repro_torch.serving.core import Request, RequestOutput, SlotSnapshot
    from repro_torch.serving.scheduler import SamplingParams
    return {b"Q": Request, b"P": SamplingParams, b"O": RequestOutput,
            b"S": SlotSnapshot}


_TAG_OF: dict[type, bytes] = {}
_TYPE_OF: dict[bytes, type] = {}


def _registry() -> dict[type, bytes]:
    if not _TAG_OF:
        _TYPE_OF.update(_serving_types())
        _TAG_OF.update({t: tag for tag, t in _TYPE_OF.items()})
        from repro_torch import _sanitize
        san = _sanitize.load()
        if san is not None:
            san.check_wire_manifest(
                WIRE_FIELDS, {t.__name__: t for t in _TAG_OF})
    return _TAG_OF


def _np_dtype(name: str) -> np.dtype:
    if name == "bfloat16":   # carried as its 16-bit pattern
        return np.dtype(np.uint16)
    try:
        return np.dtype(name)
    except TypeError as e:
        raise ProtocolError(f"unknown array dtype {name!r}") from e


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name of a tensor's dtype ("bfloat16" for bf16)."""
    return str(t.dtype).removeprefix("torch.")


def _tensor_raw(t: torch.Tensor) -> tuple[str, tuple, bytes]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy().tobytes()
    return _dtype_name(t), tuple(t.shape), t.numpy().tobytes()


def _enc_array(name: str, shape: tuple, raw: bytes, out: bytearray) -> None:
    out += b"a"
    _enc_str(name, out)
    out += struct.pack(">B", len(shape))
    out += struct.pack(f">{len(shape)}I", *shape)
    out += struct.pack(">I", len(raw))
    out += raw


def _enc_str(s: str, out: bytearray) -> None:
    b = s.encode("utf-8")
    out += struct.pack(">I", len(b))
    out += b


def _enc(obj, out: bytearray) -> None:
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif isinstance(obj, np.bool_):
        out += b"T" if obj else b"F"
    elif isinstance(obj, (int, np.integer)):
        out += b"i"
        out += struct.pack(">q", int(obj))
    elif isinstance(obj, (float, np.floating)):
        out += b"f"
        out += struct.pack(">d", float(obj))
    elif isinstance(obj, str):
        out += b"s"
        _enc_str(obj, out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out += b"y"
        out += struct.pack(">I", len(b))
        out += b
    elif isinstance(obj, torch.Tensor):
        _enc_array(*_tensor_raw(obj), out)
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        _enc_array(a.dtype.name, a.shape, a.tobytes(), out)
    elif type(obj) in _registry():
        fields = dataclasses.fields(obj)
        out += _TAG_OF[type(obj)]
        out += struct.pack(">I", len(fields))
        for f in fields:
            _enc_str(f.name, out)
            _enc(getattr(obj, f.name), out)
    elif isinstance(obj, (list, tuple)):
        out += b"l" if isinstance(obj, list) else b"u"
        out += struct.pack(">I", len(obj))
        for v in obj:
            _enc(v, out)
    elif isinstance(obj, dict):
        out += b"d"
        out += struct.pack(">I", len(obj))
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    else:
        raise ProtocolError(
            f"cannot encode {type(obj).__name__} on the fleet wire")


def encode(obj) -> bytes:
    """Serialize one value (commands, replies, snapshots) to bytes."""
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


class _Reader:
    __slots__ = ("data", "off")

    def __init__(self, data: bytes, off: int = 0):
        self.data = data
        self.off = off

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ProtocolError(
                f"truncated payload: wanted {n} bytes at offset {self.off}, "
                f"have {len(self.data) - self.off}")
        b = self.data[self.off:self.off + n]
        self.off += n
        return b

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def str_(self) -> str:
        return self.take(self.u32()).decode("utf-8")


def _dec(r: _Reader):
    tag = r.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return struct.unpack(">q", r.take(8))[0]
    if tag == b"f":
        return struct.unpack(">d", r.take(8))[0]
    if tag == b"s":
        return r.str_()
    if tag == b"y":
        return r.take(r.u32())
    if tag == b"a":
        name = r.str_()
        dtype = _np_dtype(name)
        ndim = struct.unpack(">B", r.take(1))[0]
        shape = struct.unpack(f">{ndim}I", r.take(4 * ndim))
        raw = r.take(r.u32())
        if len(raw) % dtype.itemsize:
            raise ProtocolError(f"array payload of {len(raw)} bytes is not "
                                f"a whole number of {name} elements")
        a = np.frombuffer(raw, dtype=dtype)
        if a.size != int(np.prod(shape, dtype=np.int64)):
            raise ProtocolError(
                f"array payload {a.size} elements does not fill {shape}")
        # frombuffer views are read-only; engines write into injected state
        if name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).reshape(shape).copy()
                                    ).view(torch.bfloat16)
        return torch.from_numpy(a.reshape(shape).copy())
    if tag in (b"l", b"u"):
        n = r.u32()
        vals = [_dec(r) for _ in range(n)]
        return vals if tag == b"l" else tuple(vals)
    if tag == b"d":
        n = r.u32()
        return {_dec(r): _dec(r) for _ in range(n)}
    _registry()
    cls = _TYPE_OF.get(tag)
    if cls is not None:
        n = r.u32()
        kv = {}
        for _ in range(n):
            name = r.str_()
            kv[name] = _dec(r)
        known = {f.name for f in dataclasses.fields(cls) if f.init}
        # unknown names are a NEWER sender's trailing fields: skip them
        return cls(**{k: v for k, v in kv.items() if k in known})
    raise ProtocolError(f"unknown wire tag {tag!r}")


def decode(data: bytes):
    """Deserialize one :func:`encode`-d value; the whole buffer must be
    consumed (trailing garbage is a framing bug, not padding)."""
    r = _Reader(data)
    obj = _dec(r)
    if r.off != len(data):
        raise ProtocolError(
            f"{len(data) - r.off} trailing bytes after decoded value")
    return obj


# ----------------------------------------------------------------------
# framing
# ----------------------------------------------------------------------
def frame(payload: bytes, max_payload: int = MAX_PAYLOAD) -> bytes:
    """Wrap one encoded payload in a length-prefixed, versioned frame."""
    if len(payload) > max_payload:
        raise ProtocolError(
            f"payload of {len(payload)} bytes exceeds the "
            f"{max_payload}-byte frame cap")
    return _HEADER.pack(MAGIC, WIRE_VERSION, 0, len(payload)) + payload


class FrameDecoder:
    """Incremental frame reassembly over an arbitrary chunking of the byte
    stream.  ``feed`` returns the payloads of every frame completed by the
    chunk (possibly none, possibly several) and keeps partial frames
    buffered for the next call."""

    def __init__(self, max_payload: int = MAX_PAYLOAD):
        self._buf = bytearray()
        self.max_payload = max_payload

    def feed(self, data: bytes) -> list[bytes]:
        self._buf += data
        out = []
        while len(self._buf) >= HEADER_SIZE:
            magic, version, _flags, n = _HEADER.unpack_from(self._buf)
            if magic != MAGIC:
                raise ProtocolError(
                    f"bad frame magic {bytes(magic)!r} (expected {MAGIC!r}) "
                    f"— stream is corrupt or not a fleet peer")
            if version != WIRE_VERSION:
                raise ProtocolError(
                    f"unsupported wire version {version} "
                    f"(speaking {WIRE_VERSION})")
            if n > self.max_payload:
                raise ProtocolError(
                    f"frame announces {n} payload bytes, cap is "
                    f"{self.max_payload}")
            if len(self._buf) < HEADER_SIZE + n:
                break
            out.append(bytes(self._buf[HEADER_SIZE:HEADER_SIZE + n]))
            del self._buf[:HEADER_SIZE + n]
        return out


# ----------------------------------------------------------------------
# SlotSnapshot byte format
# ----------------------------------------------------------------------
def _snap_dtype(snap) -> str:
    if not snap.pages:
        return ""
    a = snap.pages[0][0]
    return _dtype_name(a) if isinstance(a, torch.Tensor) else a.dtype.name


def snapshot_to_bytes(snap) -> bytes:
    """``SlotSnapshot`` → bytes: geometry header + encoded field map."""
    body = encode({f.name: getattr(snap, f.name)
                   for f in dataclasses.fields(snap)})
    fam = snap.family.encode("utf-8")
    dt = _snap_dtype(snap).encode("utf-8")
    return b"".join([
        SNAP_MAGIC, struct.pack(">H", SNAP_VERSION),
        struct.pack(">B", len(fam)), fam,
        struct.pack(">I", int(snap.page_size)),
        struct.pack(">B", len(dt)), dt,
        struct.pack(">I", len(snap.pages)),
        body,
    ])


def peek_snapshot_header(data: bytes) -> tuple[dict, int]:
    """Parse just the geometry header; returns (header dict, body offset).
    This is what a receiver guards on before paying for the body decode."""
    r = _Reader(data)
    magic = r.take(4)
    if magic != SNAP_MAGIC:
        raise ProtocolError(f"bad snapshot magic {magic!r}")
    version = struct.unpack(">H", r.take(2))[0]
    if version != SNAP_VERSION:
        raise ProtocolError(f"unsupported snapshot version {version}")
    fam = r.take(struct.unpack(">B", r.take(1))[0]).decode("utf-8")
    page_size = r.u32()
    dt = r.take(struct.unpack(">B", r.take(1))[0]).decode("utf-8")
    n_pages = r.u32()
    return ({"family": fam, "page_size": page_size, "dtype": dt,
             "n_pages": n_pages, "version": version}, r.off)


def snapshot_from_bytes(data: bytes, expect_family: str | None = None,
                        expect_page_size: int | None = None,
                        expect_dtype: str | None = None):
    """bytes → ``SlotSnapshot``, with the geometry guard: a caller that
    knows its own family / page_size / page dtype passes them as
    ``expect_*`` and gets a ``ValueError`` on mismatch *before* the body
    is decoded (the same contract as ``EngineCore.inject_slot``)."""
    from repro_torch.serving.core import SlotSnapshot

    hdr, off = peek_snapshot_header(data)
    for key, want in (("family", expect_family),
                      ("page_size", expect_page_size),
                      ("dtype", expect_dtype)):
        if want is not None and hdr[key] != want:
            raise ValueError(
                f"snapshot {key}={hdr[key]!r} does not match the "
                f"receiver's {key}={want!r}")
    fields = decode(data[off:])
    if not isinstance(fields, dict):
        raise ProtocolError("snapshot body is not a field map")
    known = {f.name for f in dataclasses.fields(SlotSnapshot) if f.init}
    snap = SlotSnapshot(**{k: v for k, v in fields.items() if k in known})
    if snap.family != hdr["family"] or snap.page_size != hdr["page_size"]:
        raise ProtocolError("snapshot header disagrees with its body")
    return snap
