"""Training-health diagnostics on the device: the packed telemetry vector
(counterpart of byol_tpu/observability/health.py, the same layout).

BYOL fails SILENTLY: the loss keeps falling while the target network
degenerates (representation collapse), trust ratios run away, or the EMA
target stops tracking.  The train step (training/steps.py, under
``StepConfig.telemetry``) computes the signals below on the card as a few
torch reductions over its flat fp32 buffers and packs them into one
12-float vector; observability/telemetry.py reads it back later without
blocking the step loop.

The buffers are zero-padded to whole 128-lane rows per leaf; the padding
adds nothing to any norm or count, so a norm over a buffer is the norm
over its leaves.  Every reduction accumulates in fp32 (float64 for a
float64 buffer, a test's).  Where the JAX function reads a pytree, these
take a tensor or a sequence of tensors.

``HEALTH_FIELDS`` names every slot; :func:`pack` and :func:`unpack` are
the only writers and readers of the layout:

- ``grad_norm`` / ``update_norm`` / ``param_norm``: l2 norms of the
  step's (averaged) gradient, the update the optimizer applied, and the
  post-step params;
- ``ema_drift`` / ``ema_drift_rel``: l2 distance between the params and
  the EMA target after its tick, and that over ``param_norm``;
- ``trust_min`` / ``trust_median`` / ``trust_max``: the spread of the LARS
  trust ratios the update applied to the adapted leaves;
- ``collapse_feature_std`` / ``collapse_cosine_mean``: the collapse
  signature of the stop-grad target projections;
- ``nonfinite_count``: non-finite values in the gradient and the loss
  (``--nan-policy`` keys off it);
- ``loss``: the step loss.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from byol_tpu_torch.core.precision import at_least_fp32

HEALTH_FIELDS: Tuple[str, ...] = (
    "grad_norm",
    "update_norm",
    "param_norm",
    "ema_drift",
    "ema_drift_rel",
    "trust_min",
    "trust_median",
    "trust_max",
    "collapse_feature_std",
    "collapse_cosine_mean",
    "nonfinite_count",
    "loss",
)

_EPS = 1e-12

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _leaves(tensors: Tensors):
    return [tensors] if torch.is_tensor(tensors) else list(tensors)


_ROW = 128


def _square_norm(t: torch.Tensor) -> torch.Tensor:
    """Sum of squares of ``t`` in fp32.  A flat buffer (whole 128-lane
    rows) reduces in two levels, row norms and then their squares' sum:
    one pass with no buffer-sized temporary, and exact to fp32 rounding on
    the CPU too, where one ``vector_norm`` over 10^7 elements drifts by
    ~1e-3."""
    t = t.reshape(-1)
    dt = torch.promote_types(t.dtype, torch.float32)
    if t.numel() > _ROW and t.numel() % _ROW == 0:
        rows = torch.linalg.vector_norm(t.view(-1, _ROW), dim=1, dtype=dt)
        return rows.square().sum()
    return torch.linalg.vector_norm(t, dtype=dt).square()


def global_norm(tensors: Tensors) -> torch.Tensor:
    """l2 norm over every element of a tensor or a sequence of tensors,
    accumulated in fp32."""
    leaves = _leaves(tensors)
    if not leaves:
        return torch.zeros(())
    return torch.stack([_square_norm(t) for t in leaves]).sum().sqrt()


def nonfinite_count(tensors: Tensors) -> torch.Tensor:
    """Number of non-finite (NaN/inf) values, as an fp32 scalar."""
    leaves = _leaves(tensors)
    if not leaves:
        return torch.zeros(())
    # integer counts, exact past fp32's 2^24
    return torch.stack([(~torch.isfinite(t)).sum()
                        for t in leaves]).sum().float()


def collapse_stats(proj: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The BYOL collapse signature of a (B, D) projection batch:
    ``(feature_std, cosine_mean)``.

    - ``feature_std``: mean over features of the per-feature POPULATION
      std over the batch (``jnp.std``'s, ``correction=0``); collapse
      drives it to 0.
    - ``cosine_mean``: mean pairwise cosine similarity of the B rows, in
      closed form from the norm of the summed unit rows, ``(|sum_i u_i|^2
      - B) / (B (B - 1))``; collapse drives it to 1.
    """
    p = proj.float()
    feature_std = p.std(dim=0, correction=0).mean()
    b = p.shape[0]
    if b < 2:
        return feature_std, torch.ones((), device=p.device)
    u = p / (torch.linalg.vector_norm(p, dim=1, keepdim=True) + _EPS)
    s = u.sum(dim=0)
    cosine_mean = (s.square().sum() - b) / (b * (b - 1))
    return feature_std, cosine_mean


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values of an even count
    (``torch.median`` returns the lower one)."""
    s = x.reshape(-1).sort().values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) / 2


def pack(values: Dict[str, Any]) -> torch.Tensor:
    """Pack the named signals into the (len(HEALTH_FIELDS),) fp32 vector,
    on the device of the first tensor among them."""
    missing = set(HEALTH_FIELDS) - set(values)
    extra = set(values) - set(HEALTH_FIELDS)
    if missing or extra:
        raise ValueError(
            f"health vector fields mismatch: missing={sorted(missing)} "
            f"extra={sorted(extra)}")
    device = next((v.device for v in values.values() if torch.is_tensor(v)),
                  torch.device("cpu"))
    return torch.stack([torch.as_tensor(values[k], dtype=torch.float32,
                                        device=device).reshape(())
                        for k in HEALTH_FIELDS])


def unpack(vec: Any) -> Dict[str, float]:
    """Host-side inverse of :func:`pack`: vector -> {field: python float}."""
    arr = np.asarray(vec, np.float64).reshape(-1)
    if arr.shape[0] != len(HEALTH_FIELDS):
        raise ValueError(
            f"health vector has {arr.shape[0]} slots; schema expects "
            f"{len(HEALTH_FIELDS)} ({HEALTH_FIELDS})")
    return {k: float(arr[i]) for i, k in enumerate(HEALTH_FIELDS)}


def health_stats(*, grads: Tensors, update_norm: torch.Tensor,
                 params: Tensors, target_params: Tensors, loss: torch.Tensor,
                 collapse: Tuple[torch.Tensor, torch.Tensor],
                 trust_ratios: torch.Tensor,
                 grad_stats: Optional[Tuple[torch.Tensor, torch.Tensor]]
                 = None, norm: Callable[[Tensors], torch.Tensor] = global_norm
                 ) -> torch.Tensor:
    """The packed health vector of one optimizer step.

    ``update_norm`` is the norm of the applied update: the train step
    passes ``lr * |m'|`` under the fused update (the norm of the ``-lr
    m'`` its kernels add, so no update tensor is made for the diagnostic)
    and the norm of the update its chain returned otherwise (JAX's
    function takes the update tree).  ``collapse`` is ``collapse_stats`` of the stop-grad
    target projections, mean-accumulated over the microbatches;
    ``trust_ratios`` the ratios the update applied to the adapted leaves
    (K1a's own under the fused update).  ``grad_stats`` (the gradient's
    norm and non-finite count) replaces what ``grads`` would give where
    the averaged gradient lives on the ranks' ranges (ZeRO-1), or on the
    model ranks' shards (the tensor-parallel heads), where ``norm`` is
    the whole tree's norm of the params' and the drift's flat buffers.
    The result is a fresh tensor, never a view of the state."""
    param_norm = norm(params)
    drift = norm([at_least_fp32(p) - at_least_fp32(t) for p, t in
                  zip(_leaves(params), _leaves(target_params))])
    feature_std, cosine_mean = collapse
    tr = trust_ratios.float()
    grad_norm, grad_nonfinite = (grad_stats if grad_stats is not None else
                                 (global_norm(grads), nonfinite_count(grads)))
    return pack({
        "grad_norm": grad_norm,
        "update_norm": update_norm,
        "param_norm": param_norm,
        "ema_drift": drift,
        "ema_drift_rel": drift / (param_norm + _EPS),
        "trust_min": tr.min(),
        "trust_median": median(tr),
        "trust_max": tr.max(),
        "collapse_feature_std": feature_std,
        "collapse_cosine_mean": cosine_mean,
        "nonfinite_count": grad_nonfinite + nonfinite_count(loss),
        "loss": loss,
    })
