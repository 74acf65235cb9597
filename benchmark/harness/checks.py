"""The numbers that decide ``correct``, each held to its limit.

Training (a run's first optimizer steps, program against reference):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the first gradient's norms,
  over the larger of the reference leaf's norm and the median leaf's;
- ``change_gap``: the same of the norms of each leaf's change over the
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf with no gradient, as a bias
  before a BatchNorm, moves by round-off alone);
- ``target_gap``, ``polyak_gap``: the same as ``change_gap`` of the
  target's (the EMA weights') and the Polyak average's change over the
  steps; ``momentum_gap``: the same of each leaf's momentum norm after
  the steps (a step that leaves one of these buffers unchanged reads 1
  there, where the parameters' change barely shows it);
- ``grad_gap_median``: the median leaf's gap of the first gradient,
  steadier from seed to seed where one small leaf's noise sets the worst;
- ``probe_grad_gap``: the largest relative gap of the linear probe's
  leaves' first gradient (it follows each row's label, so it tells which
  rows the step saw).

Serving: ``embed_gap``, the largest over the answered requests of
|served - reference| / |reference - mean reference embedding| (the mean
over the pool: the gap against what tells one image from another), and
``unanswered``, the requests that never got an answer.

A cell's file (``cells/<cell>.json``) names the numbers it compares and
their limits; the others are printed beside them for the record.
"""
from __future__ import annotations

import statistics
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

CHANGE_FLOOR = 1e-3


def _leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
               names: Sequence[str]) -> Dict[str, float]:
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}


def train_readings(prog, ref) -> Dict[str, float]:
    if set(prog["first_grad"]) != set(ref["first_grad"]):
        raise ValueError("program and reference hold different leaves")
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                   ref["loss"]))
    names = sorted(ref["first_grad"])
    grad = _leaf_gaps(prog["first_grad"], ref["first_grad"], names)
    med = statistics.median(ref["first_grad"][n] for n in names)
    moved = [n for n in names if ref["first_grad"][n] >= CHANGE_FLOOR * med]
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    worst_grad = max(grad, key=grad.get)
    worst_change = max(change, key=change.get)
    buffers = {}
    for key, name in (("target_change", "target"),
                      ("polyak_change", "polyak"), ("momentum", "momentum")):
        if key not in ref:
            continue
        if key not in prog:
            raise ValueError(f"the program holds no {name} buffer")
        gaps = _leaf_gaps(prog[key], ref[key], moved)
        worst = max(gaps, key=gaps.get)
        buffers.update({f"{name}_gap": gaps[worst],
                        f"{name}_gap_median": statistics.median(
                            gaps.values()),
                        f"_{name}_leaf": worst})
    return {"loss_gap": loss,
            "probe_grad_gap": max(
                abs(prog["first_grad"][n] - ref["first_grad"][n])
                / ref["first_grad"][n] for n in names
                if n.startswith("probe.")),
            "grad_gap": grad[worst_grad],
            "change_gap": change[worst_change],
            "grad_gap_median": statistics.median(grad.values()),
            **buffers,
            "_grad_leaf": worst_grad, "_change_leaf": worst_change,
            "_leaves_left_out": len(names) - len(moved)}


def embed_gaps(served: np.ndarray, index: np.ndarray,
               reference: np.ndarray) -> np.ndarray:
    """Per answered request: ``served`` (n, D) embeddings of pool images
    ``index`` (n,) against the reference's (pool, D)."""
    ref = reference.astype(np.float64)
    spread = np.linalg.norm(ref - ref.mean(axis=0), axis=1)
    diff = np.linalg.norm(served.astype(np.float64) - ref[index], axis=1)
    return diff / spread[index]


def judge(readings: Mapping[str, float], limits: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``(correct, {name: {'value', 'limit'}})`` over the limits given;
    a reading that is not a number fails."""
    compared = {n: {"value": float(readings[n]), "limit": float(lim)}
                for n, lim in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared
