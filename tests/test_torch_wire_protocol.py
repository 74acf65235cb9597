"""The port's wire format v1 against the JAX package's, byte for byte.

Frames are compared as bytes (no tolerance): the port's encoder must write
what JAX's writes, each package must decode the other's frames to equal
arrays, and every malformed body of JAX's own table
(tests/test_net.py::TestProtocol) must map to the same ``(status, code)``
in both packages.  No sockets, no model.
"""
import json
import struct

import numpy as np
import pytest

from byol_tpu.serving.net import client as jax_client
from byol_tpu.serving.net import protocol as jax_protocol
from byol_tpu_torch.serving.net import client as torch_client
from byol_tpu_torch.serving.net import protocol as torch_protocol

SHAPE = (4, 4, 3)
PACKAGES = {"jax": jax_protocol, "torch": torch_protocol}


def _frame_bytes(header: dict, payload: bytes) -> bytes:
    head = json.dumps(header).encode()
    return struct.pack(">I", len(head)) + head + payload


def _requests():
    rng = np.random.RandomState(0)
    return {
        "uint8": rng.randint(0, 256, size=(3, *SHAPE), dtype=np.uint8),
        "float32": rng.rand(5, *SHAPE).astype(np.float32),
        "single_image": rng.rand(*SHAPE).astype(np.float32),
    }


@pytest.mark.parametrize("kind", ["uint8", "float32", "single_image"])
def test_request_frames_equal_jax_bytes(kind):
    images = _requests()[kind]
    assert (torch_protocol.encode_request(images)
            == jax_protocol.encode_request(images))


def test_response_frames_equal_jax_bytes():
    emb = np.random.RandomState(1).randn(3, 7).astype(np.float32)
    assert (torch_protocol.encode_response(emb)
            == jax_protocol.encode_response(emb))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("kind", ["uint8", "float32", "single_image"])
def test_each_package_decodes_the_others_requests(writer, reader, kind):
    images = _requests()[kind]
    body = PACKAGES[writer].encode_request(images)
    got = PACKAGES[reader].decode_request(body, input_shape=SHAPE,
                                          max_rows=16)
    want = images if images.ndim == 4 else images[None]
    if want.dtype == np.uint8:
        # the one conversion rule: x / 255 in float32, on the host
        want = want.astype(np.float32) / np.float32(255.0)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_each_package_decodes_the_others_responses(writer, reader):
    emb = np.random.RandomState(2).randn(4, 6).astype(np.float32)
    got = PACKAGES[reader].decode_response(
        PACKAGES[writer].encode_response(emb))
    np.testing.assert_array_equal(got, emb)


def test_uint8_rule_equals_float_client_bitwise():
    u8 = _requests()["uint8"]
    from_u8 = torch_protocol.decode_request(
        torch_protocol.encode_request(u8), input_shape=SHAPE, max_rows=16)
    as_float = u8.astype(np.float32) / np.float32(255.0)
    from_f32 = torch_protocol.decode_request(
        torch_protocol.encode_request(as_float), input_shape=SHAPE,
        max_rows=16)
    np.testing.assert_array_equal(from_u8, from_f32)


MALFORMED = [
    (b"", 400, "bad_frame"),                      # shorter than prefix
    (b"\x00\x00\x00\x05ab", 400, "bad_frame"),    # ends inside header
    (struct.pack(">I", jax_protocol.MAX_HEADER_BYTES + 1) + b"x",
     400, "bad_frame"),                           # header over the cap
    (_frame_bytes({"v": 99, "dtype": "uint8", "shape": [1, 4, 4, 3]},
                  bytes(48)), 400, "bad_version"),
    (struct.pack(">I", 7) + b"notjson", 400, "bad_header"),
    (_frame_bytes({"v": 1, "dtype": "float64",
                   "shape": [1, 4, 4, 3]}, bytes(8 * 48)),
     415, "unsupported_dtype"),
    (_frame_bytes({"v": 1, "dtype": "uint8", "shape": [1, 4, 4]},
                  bytes(16)), 400, "bad_shape"),  # ndim mismatch
    (_frame_bytes({"v": 1, "dtype": "uint8", "shape": [1, 9, 9, 3]},
                  bytes(243)), 400, "bad_shape"),  # row-shape mismatch
    (_frame_bytes({"v": 1, "dtype": "uint8", "shape": [1, 4, 4, 3]},
                  bytes(10)), 400, "payload_size_mismatch"),  # short
    (_frame_bytes({"v": 1, "dtype": "uint8", "shape": [1, 4, 4, 3]},
                  bytes(99)), 400, "payload_size_mismatch"),  # long
    (_frame_bytes({"v": 1, "dtype": "uint8", "shape": [17, 4, 4, 3]},
                  bytes(17 * 48)), 413, "too_many_rows"),
]


def _decode_error(protocol, body):
    with pytest.raises(protocol.WireError) as e:
        protocol.decode_request(body, input_shape=SHAPE, max_rows=16)
    return e.value.status, e.value.code


@pytest.mark.parametrize("body,status,code", MALFORMED)
def test_malformed_bodies_map_alike_in_both_packages(body, status, code):
    assert _decode_error(jax_protocol, body) == (status, code)
    assert _decode_error(torch_protocol, body) == (status, code)


def test_constants_and_max_request_bytes_agree():
    assert torch_protocol.MAX_HEADER_BYTES == jax_protocol.MAX_HEADER_BYTES
    assert torch_protocol.PROTOCOL_VERSION == jax_protocol.PROTOCOL_VERSION
    for shape, rows in ((SHAPE, 16), ((224, 224, 3), 64), ((32, 32, 1), 8)):
        assert (torch_protocol.max_request_bytes(shape, rows)
                == jax_protocol.max_request_bytes(shape, rows))
    biggest = torch_protocol.encode_request(np.zeros((16, *SHAPE),
                                                     np.float32))
    assert len(biggest) <= torch_protocol.max_request_bytes(SHAPE, 16)


def test_encode_refuses_other_dtypes_in_both_packages():
    x = np.zeros((1, *SHAPE), np.float64)
    for protocol in PACKAGES.values():
        with pytest.raises(ValueError, match="uint8 or float32"):
            protocol.encode_request(x)


@pytest.mark.parametrize("spec", ["127.0.0.1:8700", "0.0.0.0:0",
                                  "[::1]:9000", "8700", "host:80x0",
                                  ":80"])
def test_parse_address_agrees(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))
    assert (outcome(torch_client.parse_address)
            == outcome(jax_client.parse_address))
