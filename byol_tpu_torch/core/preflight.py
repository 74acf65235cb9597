"""Device selection and the killable preflight for the entry points
(counterpart of byol_tpu/core/preflight.py).

:func:`resolve_device`: the card, or the CPU on request.  There is no
silent CPU fallback: a run that did not ask for the CPU and finds no card
fails here, before it builds anything.

:func:`preflight_backend`: a wedged GPU runtime (a card left in a bad
state by a killed process, a hung GPU) can block the first CUDA call of
the next process forever inside native code, where Python cannot
interrupt it; an unattended run then hangs with no diagnosis.  The probe makes the CUDA
context, runs a matmul with a readback in a subprocess that is killed on
timeout, and checks that the child really landed on ``cuda``: a child
that finds no card runs on the CPU, which would pass the matmul and defer
the failure (or a silent CPU run) to the caller.  Both CLIs run it before
they touch the card, as JAX's run theirs; not under ``--no-cuda``, and
not for a multi-process launch, where every rank would probe the card at
once (JAX skips multi-host runs).
"""
from __future__ import annotations

import subprocess
import sys

import torch

# the probe child: the CUDA context, a matmul, a readback, the device type
PROBE = ("import torch; "
         "dev = 'cuda' if torch.cuda.is_available() else 'cpu'; "
         "x = torch.ones((8, 8), device=dev); "
         "float((x @ x).sum()); print(x.device.type)")


def resolve_device(no_cuda: bool = False) -> torch.device:
    if no_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass --no-cuda (device='cpu') to run "
            "on the CPU")
    return torch.device("cuda")


def preflight_backend(timeout_s: float = 180.0) -> bool:
    """Probe the card in a killable subprocess.  True when a matmul ran on
    ``cuda`` and read back; False, with the diagnosis on stderr, when the
    child hung past ``timeout_s``, failed, or landed on the CPU."""
    try:
        probe = subprocess.run([sys.executable, "-c", PROBE],
                               timeout=timeout_s, capture_output=True,
                               text=True)
    except subprocess.TimeoutExpired:
        print(f"byol_tpu_torch: CUDA failed to initialize within "
              f"{timeout_s:.0f}s — the GPU runtime is likely wedged (a "
              "killed process can leave the card hung).", file=sys.stderr)
        return False
    if probe.returncode != 0:
        print("byol_tpu_torch: backend probe failed:\n" + probe.stderr[-2000:],
              file=sys.stderr)
        return False
    lines = probe.stdout.strip().splitlines()
    child = lines[-1] if lines else ""
    if child != "cuda":
        print(f"byol_tpu_torch: the probe landed on {child or 'nothing'!r}, "
              "not on a CUDA card — no card is visible, or the GPU runtime "
              "is dead and torch fell back to the CPU.", file=sys.stderr)
        return False
    return True
