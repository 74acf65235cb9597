"""Writes this directory's zstd sample: 256 KiB of float32 weights
(N(0, 0.05) from seed 0, as a checkpoint's leaves hold them) compressed
by the ``zstandard`` package at level 1, as orbax compresses zarr chunks
(Huffman-coded literals in four streams, FSE-coded sequences), and the
SHA-256 of the uncompressed bytes.  The card's machine has no zstd
compressor: chip_smoke.py times the port's decoder on this frame.

    python tests/fixtures/zstd_sample/make_sample.py
"""
import hashlib
import json
from pathlib import Path

import numpy as np
import zstandard

HERE = Path(__file__).resolve().parent


def main():
    data = (np.random.RandomState(0).standard_normal(1 << 16) * 0.05).astype(
        np.float32).tobytes()
    frame = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(
        data)
    (HERE / "float32_level1.zst").write_bytes(frame)
    (HERE / "float32_level1.json").write_text(json.dumps({
        "bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(),
        "level": 1, "frame_bytes": len(frame)}, indent=1) + "\n")
    print(f"wrote {len(frame)} bytes for {len(data)}")


if __name__ == "__main__":
    main()
