"""Puts the benchmark's folder and the repository's root on the path, and
shrinks a cell to a size the CPU runs in seconds: the same network
families and code paths at a small image and batch."""
import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO)]


def tiny(name: str, precision: str = "--half"):
    """Cell ``name`` at a CPU's size; ``precision`` '--no-half' computes
    the program in float32."""
    from harness import registry
    conf = copy.deepcopy(registry.spec(REPO, name))
    size = 72 if conf["arch"]["family"] == "resnet" else 32
    conf["image_size"] = size
    conf["flags"] = [str(size) if f == "224" else f for f in conf["flags"]]
    conf["flags"] = [precision if f == "--half" else f
                     for f in conf["flags"]]
    t = conf["traffic"]
    if t["driver"] == "train":
        t.update(batch_size=8, accum_steps=min(t["accum_steps"], 2),
                 check_steps=2, profile_steps=0)
    else:
        t["pool"] = 8
        conf["cell"]["rate_per_s"] = 20.0
    return conf


@pytest.fixture(autouse=True)
def _process_settings():
    """A serving run sets torch's thread count and the interpreter's
    switch interval for its process; the tests that follow in it get
    theirs back."""
    import torch
    n, interval = torch.get_num_threads(), sys.getswitchinterval()
    yield
    torch.set_num_threads(n)
    sys.setswitchinterval(interval)
