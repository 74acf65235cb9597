"""The port's hand-written Zstandard decoder (checkpoint/csrc/zstd_decode.cc
through checkpoint/zstd.py) held bitwise against the ``zstandard``
package's compressor on the same inputs: levels -5 to 19 and long-distance
matching, sizes from 0 B to 4 MiB, checksum and content size on and off,
concatenated and skippable frames, random, constant, float32 and text
data; random inputs under hypothesis; truncated, corrupted and
checksum-broken frames must raise ValueError (and never crash the
process).  Its CRC-32C against google-crc32c."""
import struct

import google_crc32c
import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from byol_tpu_torch.checkpoint import zstd


def _data(kind, n, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.bytes(n)
    if kind == "constant":
        return b"\x07" * n
    if kind == "float32":
        return (rng.standard_normal((n + 3) // 4) * 0.05).astype(
            np.float32).tobytes()[:n]
    words = [b"alpha ", b"beta ", b"gamma", b"\n", b"delta, ", b"epsilon"]
    text = b"".join(rng.choice(words, n // 4 + 1))
    return text[:n]


def _compress(data, level, checksum=True, content_size=True):
    if level == "long":
        params = zstandard.ZstdCompressionParameters.from_level(
            19, enable_ldm=True, window_log=27,
            write_checksum=checksum, write_content_size=content_size)
        return zstandard.ZstdCompressor(
            compression_params=params).compress(data)
    return zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size).compress(data)


def _skippable(payload, magic_low=0):
    return struct.pack("<II", 0x184D2A50 | magic_low, len(payload)) + payload


KINDS = ("random", "constant", "float32", "text")
LEVELS = (-5, 1, 3, 9, 19, "long")
CASES = []
# every level on every kind of data, checksum and content size in turns
for i, level in enumerate(LEVELS):
    for j, kind in enumerate(KINDS):
        CASES.append((f"L{level}-{kind}-100k", kind, 100_000, level,
                      (i + j) % 2 == 0, (i + j) % 3 != 0))
# sizes from 0 B to 4 MiB (block edges among them)
for n in (0, 1, 17, 4096, 131_072, 131_073, 1 << 20, 4 << 20):
    for kind in ("float32", "text"):
        CASES.append((f"L3-{kind}-{n}", kind, n, 3, True, True))
CASES += [("long-text-1M", "text", 1 << 20, "long", True, False),
          ("L19-float32-1M", "float32", 1 << 20, 19, False, True),
          ("L1-random-4M-nosize", "random", 4 << 20, 1, True, False)]
FRAMES = ("concatenated", "skippable-first", "skippable-between",
          "skippable-only", "concatenated-nosize")


def _framed(kind):
    a, b = _data("text", 70_000, 1), _data("float32", 50_000, 2)
    fa, fb = _compress(a, 3), _compress(b, 1, checksum=False)
    if kind == "concatenated":
        return fa + fb, a + b
    if kind == "skippable-first":
        return _skippable(b"orbax") + fa, a
    if kind == "skippable-between":
        return fa + _skippable(b"x" * 300, 15) + fb, a + b
    if kind == "skippable-only":
        return _skippable(b"nothing"), b""
    return (_compress(a, 9, content_size=False)
            + _compress(b, -5, content_size=False)), a + b


@pytest.mark.parametrize(
    "case", [c[0] for c in CASES] + [f"frames-{f}" for f in FRAMES])
def test_decompress_is_bitwise_zstandard(case):
    """decompress() equals the data zstandard compressed, returned and
    written into a caller's buffer (whose unwritten tail it leaves
    alone); content_size() is the frames' declared size or None."""
    if case.startswith("frames-"):
        src, want = _framed(case[len("frames-"):])
        declared = None if case.endswith("nosize") else len(want)
    else:
        _, kind, n, level, checksum, content_size = next(
            c for c in CASES if c[0] == case)
        want = _data(kind, n)
        src = _compress(want, level, checksum, content_size)
        declared = len(want) if content_size else None
        assert zstandard.ZstdDecompressor().decompress(
            src, max_output_size=len(want) + 1) == want
    assert zstd.decompress(src) == want
    assert zstd.content_size(src) == declared
    out = np.full(len(want) + 8, 0xAB, np.uint8)
    assert zstd.decompress(src, out) == len(want)
    assert out[:len(want)].tobytes() == want
    assert (out[len(want):] == 0xAB).all()


def test_committed_sample_decodes_to_its_digest():
    """The level-1 frame chip_smoke.py times on the card's host (written
    by tests/fixtures/zstd_sample/make_sample.py)."""
    import hashlib
    import json
    from pathlib import Path
    here = Path(__file__).resolve().parent / "fixtures" / "zstd_sample"
    meta = json.loads((here / "float32_level1.json").read_text())
    frame = (here / "float32_level1.zst").read_bytes()
    out = np.empty(meta["bytes"], np.uint8)
    assert zstd.decompress(frame, out) == meta["bytes"]
    assert hashlib.sha256(out).hexdigest() == meta["sha256"]
    assert zstandard.ZstdDecompressor().decompress(frame) == out.tobytes()


@settings(max_examples=60, deadline=None)
@given(st.binary(max_size=3000), st.sampled_from([-3, 1, 4, 12]),
       st.booleans())
def test_decompress_random_inputs(data, level, checksum):
    src = _compress(data, level, checksum)
    assert zstd.decompress(src) == data


def test_output_buffer_too_small_raises():
    src = _compress(_data("text", 10_000), 3)
    with pytest.raises(ValueError, match="too small"):
        zstd.decompress(src, np.empty(9_999, np.uint8))
    with pytest.raises(ValueError, match="read-only"):
        zstd.decompress(src, np.frombuffer(bytes(10_000), np.uint8))


def test_truncated_frames_raise_value_error():
    data = _data("text", 20_000)
    for checksum in (True, False):
        src = _compress(data, 3, checksum)
        for cut in list(range(0, 40)) + list(range(40, len(src) - 1, 97)) + [
                len(src) - 1]:
            with pytest.raises(ValueError, match="offset"):
                zstd.decompress(src[:cut] if cut else b"\x28")


def test_corrupted_frames_raise_value_error_or_decode_unchanged():
    """A corrupted frame with a checksum either raises ValueError or (a
    byte the decoder never reads) gives the original bytes back."""
    rng = np.random.RandomState(5)
    raised = 0
    for kind, level in (("text", 3), ("float32", 1), ("text", 19)):
        data = _data(kind, 30_000)
        src = bytearray(_compress(data, level, True))
        for _ in range(150):
            bad = bytearray(src)
            for _ in range(rng.randint(1, 4)):
                bad[rng.randint(4, len(bad))] = rng.randint(0, 256)
            try:
                got = zstd.decompress(bytes(bad))
            except ValueError:
                raised += 1
                continue
            assert got == data
    assert raised > 400


def test_checksum_mismatch_and_bad_headers_raise():
    data = _data("float32", 5000)
    src = bytearray(_compress(data, 3, True))
    src[-1] ^= 0x01
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(src))
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00\x01\x02\x03" + bytes(src[4:]))
    # the same frame naming a dictionary (ID 5 in a 1-byte field)
    plain = _compress(data, 3, False)
    fhd = plain[4]
    with_dict = plain[:4] + bytes([fhd | 1]) + plain[5:6] + b"\x05" + plain[6:]
    if fhd & 0x20:                       # single segment: no window byte
        with_dict = plain[:4] + bytes([fhd | 1]) + b"\x05" + plain[5:]
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(with_dict)
    reserved = bytearray(plain)
    reserved[4] |= 0x08
    with pytest.raises(ValueError, match="reserved"):
        zstd.decompress(bytes(reserved))


@pytest.mark.parametrize("n", [0, 3, 31, 32, 33, 1000, 100_003])
def test_crc32c_matches_google_crc32c(n):
    data = _data("random", n, seed=n)
    assert zstd.crc32c(data) == google_crc32c.value(data)
    assert zstd.crc32c(data[n // 2:], zstd.crc32c(data[:n // 2])) == \
        google_crc32c.value(data)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    broken = tmp_path / "csrc" / "zstd_decode.cc"
    broken.parent.mkdir()
    broken.write_text("int this_is_not_cplusplus(\n")
    monkeypatch.setattr(zstd, "SRC", broken)
    monkeypatch.setattr(zstd, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(zstd, "_lib", None)
    with pytest.raises(RuntimeError, match="zstd decoder build failed"):
        zstd.load()
    assert not list((tmp_path / "_build").glob("*.so"))
