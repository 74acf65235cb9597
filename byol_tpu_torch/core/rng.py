"""Named random streams (counterpart of byol_tpu/core/rng.py).

JAX splits one root key per purpose; here each purpose gets its own
``torch.Generator``, seeded from (seed, name) through numpy's
``SeedSequence``, so streams are independent of one another and of the
order in which they are made.  The draws cannot match ``jax.random``'s:
parity tests carry the JAX weights across through ``convert.py`` instead
of redrawing them.
"""
from __future__ import annotations

import zlib
from typing import Dict, Sequence

import numpy as np
import torch


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` under ``seed`` (the name is
    hashed with crc32, so the mapping is stable across runs)."""
    words = [int(seed) & 0xFFFFFFFF, zlib.crc32(name.encode())]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def split_named(seed: int, names: Sequence[str],
                device="cpu") -> Dict[str, torch.Generator]:
    """One generator per purpose (``params``, ...)."""
    return {name: torch.Generator(device=device).manual_seed(
        stream_seed(seed, name)) for name in names}


def augment_generator(seed: int, step: int,
                      microbatch: int = 0) -> torch.Generator:
    """The CPU generator of the in-step augmentation draws of microbatch
    ``microbatch`` of optimizer step ``step`` (counterpart of
    ``augment_keys(seed, step, k)[microbatch]`` in
    byol_tpu/training/steps.py).  It depends only on (seed, step,
    microbatch), never on how many steps this process ran, nor on how many
    microbatches the step has."""
    return torch.Generator().manual_seed(
        stream_seed(seed, f"augment/{int(step)}/{int(microbatch)}"))
