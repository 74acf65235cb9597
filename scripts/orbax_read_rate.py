#!/usr/bin/env python3
"""Times the port's reader of the JAX package's orbax checkpoints on one
checkpoint: the whole TrainState (``orbax.read_train_state``, as a
resume reads it) and the serving subset (``orbax.read_weights``, params
and batch_stats only), each ``--reps`` times in turns; prints the keys
and bytes read, the seconds and MB/s of each read, on this host.

    python scripts/orbax_read_rate.py RUN_DIR/ckpt-N [--reps 3]

It imports the port only (no JAX, orbax or tensorstore).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from byol_tpu_torch.checkpoint import orbax, zstd  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--optimizer", default="lars_momentum")
    args = p.parse_args(argv)
    zstd.load()
    print(f"zstd decoder: build {zstd.build_seconds:.2f}s", flush=True)
    for _ in range(args.reps):
        for name, read in (
                ("train state", lambda st: orbax.read_train_state(
                    args.ckpt, args.optimizer, stats=st)),
                ("weights", lambda st: orbax.read_weights(args.ckpt,
                                                          stats=st))):
            stats = {}
            t0 = time.perf_counter()
            read(stats)
            wall = time.perf_counter() - t0
            mb, out = stats["bytes_read"] / 1e6, stats["array_bytes"] / 1e6
            print(f"{name}: {stats['keys_read']} of {stats['keys_total']} "
                  f"keys, {stats['leaves']} leaves, {mb:.1f} MB read, "
                  f"{out:.1f} MB of arrays, in {wall:.3f}s ({mb / wall:.1f} "
                  f"MB/s read, {out / wall:.1f} MB/s decoded)", flush=True)


if __name__ == "__main__":
    main()
