"""Wire format v1: strict-JSON header + raw tensor payload, typed errors.

A copy of byol_tpu/serving/net/protocol.py (numpy and the standard library
only; the port imports nothing of the JAX package): a frame either package
encodes, the other decodes byte for byte.

One frame, both directions::

    [4-byte big-endian header length][JSON header][raw tensor bytes]

The header is SMALL (hard cap :data:`MAX_HEADER_BYTES`) and STRICT JSON —
it is parsed with the same no-bare-NaN discipline the run log enforces
(observability/events.py).  The
payload is the tensor's raw bytes in a declared dtype and shape, so an
image batch costs exactly ``rows*H*W*C`` bytes on the wire for uint8 —
the wire-bandwidth analog of staging uint8 batches — with float32
accepted for numerics-exact clients (the bitwise-parity path).  The
uint8 conversion runs on the host, as in the JAX package: the engine
stages float32.

Request header::

    {"v": 1, "dtype": "uint8"|"float32", "shape": [rows, H, W, C]}

Response header::

    {"v": 1, "dtype": "float32", "shape": [rows, D]}

Byte order is little-endian on the wire (``<f4`` / ``|u1``), explicitly —
"whatever numpy does on this host" is not a wire contract.

Error philosophy (the service's submit validation, moved to the front
door): every way a request can be malformed — bad framing, header
over the cap, invalid JSON, unknown version, wrong dtype, shape mismatch,
truncated or trailing payload, too many rows — is *that client's* typed
:class:`WireError` with a mapped 4xx status.  Decode errors can never
kill the server (server.py catches ``WireError`` and answers; anything
else is a 500 answered-and-logged), and they can never reach the batcher
or the engine, whose own validation stays the second line of defense.
"""
from __future__ import annotations

import json
import math
import struct
from typing import Any, Dict, Tuple

import numpy as np

PROTOCOL_VERSION = 1

# the JSON header is a dozen short fields; anything bigger is hostile or
# broken, and bounding it keeps header parsing O(1) memory per request
MAX_HEADER_BYTES = 4096

_LEN = struct.Struct(">I")

# wire dtype token -> (numpy dtype on the wire, bytes per element).
# Explicitly little-endian / endian-free so the frame means the same
# thing on every host.
WIRE_DTYPES: Dict[str, np.dtype] = {
    "uint8": np.dtype("|u1"),
    "float32": np.dtype("<f4"),
}


class WireError(Exception):
    """A protocol violation attributable to ONE request: carries the HTTP
    status the server answers with and a stable machine-readable code."""

    def __init__(self, status: int, code: str, message: str) -> None:
        super().__init__(message)
        self.status = int(status)
        self.code = code
        self.message = message


def _frame(header: Dict[str, Any], payload: bytes) -> bytes:
    # strict JSON out: the writer-side twin of the decode checks below
    # (no bare NaN tokens on the wire, ever)
    head = json.dumps(header, separators=(",", ":"),
                      allow_nan=False).encode("ascii")
    if len(head) > MAX_HEADER_BYTES:
        raise ValueError(f"header {len(head)}B exceeds the "
                         f"{MAX_HEADER_BYTES}B wire cap")
    return _LEN.pack(len(head)) + head + payload


def _split(body: bytes) -> Tuple[Dict[str, Any], bytes]:
    """Frame -> (header dict, payload bytes), every failure a WireError."""
    if len(body) < _LEN.size:
        raise WireError(400, "bad_frame",
                        f"body of {len(body)}B is shorter than the 4-byte "
                        "header-length prefix")
    (hlen,) = _LEN.unpack_from(body)
    if hlen > MAX_HEADER_BYTES:
        raise WireError(400, "bad_frame",
                        f"declared header length {hlen}B exceeds the "
                        f"{MAX_HEADER_BYTES}B cap")
    if len(body) < _LEN.size + hlen:
        raise WireError(400, "bad_frame",
                        f"body ends inside the declared {hlen}B header")
    raw = body[_LEN.size:_LEN.size + hlen]
    try:
        header = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise WireError(400, "bad_header",
                        f"header is not valid JSON: {e}") from e
    if not isinstance(header, dict):
        raise WireError(400, "bad_header",
                        f"header must be a JSON object, got "
                        f"{type(header).__name__}")
    if header.get("v") != PROTOCOL_VERSION:
        raise WireError(400, "bad_version",
                        f"protocol version {header.get('v')!r} != "
                        f"supported {PROTOCOL_VERSION}")
    return header, body[_LEN.size + hlen:]


def _decode_tensor(header: Dict[str, Any], payload: bytes,
                   expected_ndim: int) -> np.ndarray:
    dtype_token = header.get("dtype")
    if dtype_token not in WIRE_DTYPES:
        raise WireError(415, "unsupported_dtype",
                        f"dtype {dtype_token!r} is not on the wire "
                        f"vocabulary {sorted(WIRE_DTYPES)}")
    shape = header.get("shape")
    if (not isinstance(shape, list) or len(shape) != expected_ndim
            or not all(isinstance(d, int) and not isinstance(d, bool)
                       and d > 0 for d in shape)):
        raise WireError(400, "bad_shape",
                        f"shape must be a list of {expected_ndim} positive "
                        f"ints, got {shape!r}")
    dtype = WIRE_DTYPES[dtype_token]
    # python-int arithmetic, NOT np.prod: a crafted shape like
    # [2**62, 32, 32, 3] wraps to 0 in int64 and would sail past this
    # check into a reshape ValueError (a 500, not the contracted 4xx)
    expected = math.prod(shape) * dtype.itemsize
    if len(payload) != expected:
        kind = "truncated" if len(payload) < expected else "trailing bytes:"
        raise WireError(400, "payload_size_mismatch",
                        f"{kind} payload carries {len(payload)}B but "
                        f"shape {shape} x {dtype_token} needs {expected}B")
    return np.frombuffer(payload, dtype=dtype).reshape(shape)


# ---------------------------------------------------------------------------
# requests (client encodes, server decodes)
# ---------------------------------------------------------------------------

def encode_request(images: np.ndarray) -> bytes:
    """``(rows, H, W, C)`` images -> one request frame.  uint8 ships raw
    (4x cheaper on the wire); float32 ships exact; anything else is the
    CALLER'S bug — encode refuses rather than silently casting."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[None]
    if images.dtype == np.uint8:
        token, wire = "uint8", np.ascontiguousarray(images)
    elif images.dtype == np.float32:
        token = "float32"
        wire = np.ascontiguousarray(images, dtype=WIRE_DTYPES["float32"])
    else:
        raise ValueError(
            f"wire images must be uint8 or float32, got {images.dtype} "
            "(cast client-side so the conversion is the client's choice)")
    header = {"v": PROTOCOL_VERSION, "dtype": token,
              "shape": [int(d) for d in images.shape]}
    return _frame(header, wire.tobytes())


def decode_request(body: bytes, *, input_shape: Tuple[int, ...],
                   max_rows: int) -> np.ndarray:
    """One request frame -> float32 ``(rows,) + input_shape`` images in the
    MODEL'S contract, every violation a mapped 4xx :class:`WireError`.

    uint8 payloads convert as ``x / 255`` in float32 — one documented,
    deterministic rule, so a uint8 client and a float32 client sending
    ``u8.astype(f32) / 255`` get bitwise-identical embeddings.
    """
    header, payload = _split(body)
    images = _decode_tensor(header, payload,
                            expected_ndim=1 + len(input_shape))
    if tuple(images.shape[1:]) != tuple(input_shape):
        raise WireError(400, "bad_shape",
                        f"request rows of shape {tuple(images.shape[1:])} "
                        f"do not match the served model's input "
                        f"{tuple(input_shape)}")
    if images.shape[0] > max_rows:
        raise WireError(413, "too_many_rows",
                        f"request of {images.shape[0]} rows exceeds the "
                        f"service's max batch {max_rows}; split it "
                        "client-side")
    if images.dtype == np.uint8:
        return images.astype(np.float32) / np.float32(255.0)
    # frombuffer views are read-only and little-endian by construction;
    # re-ownership happens at staging (engine copies into its buffer)
    return images.astype(np.float32, copy=False)


def max_request_bytes(input_shape: Tuple[int, ...], max_rows: int) -> int:
    """The hard request-body cap the server enforces BEFORE reading: the
    largest legal payload (float32 at max rows) + frame overhead.  A
    Content-Length above this is 413 without buffering a byte."""
    per_row = math.prod(int(d) for d in input_shape) \
        * WIRE_DTYPES["float32"].itemsize
    return _LEN.size + MAX_HEADER_BYTES + max_rows * per_row


# ---------------------------------------------------------------------------
# responses (server encodes, client decodes)
# ---------------------------------------------------------------------------

def encode_response(embeddings: np.ndarray) -> bytes:
    """``(rows, D)`` float32 embeddings -> one response frame."""
    emb = np.ascontiguousarray(embeddings, dtype=WIRE_DTYPES["float32"])
    header = {"v": PROTOCOL_VERSION, "dtype": "float32",
              "shape": [int(d) for d in emb.shape]}
    return _frame(header, emb.tobytes())


def decode_response(body: bytes) -> np.ndarray:
    """One response frame -> ``(rows, D)`` float32 embeddings (client
    side; a malformed response is the SERVER'S bug, but the client still
    fails typed rather than with a numpy shape error)."""
    header, payload = _split(body)
    return _decode_tensor(header, payload, expected_ndim=2)
