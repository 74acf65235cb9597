"""Offline linear evaluation, and the frozen-encoder core serving wraps.

Counterpart of byol_tpu/training/linear_eval.py on one card:

- :func:`frozen_representation_fn` (images -> fp32 representations,
  compute in the trained dtype) and its input contract :func:`_prep_inputs`,
  with a copy of ``normalize_images`` from byol_tpu/training/steps.py.
  Serving and the offline protocol both wrap it, so a served embedding is
  what linear eval scores.
- The BYOL paper's protocol: freeze the encoder, extract features of the
  train and test splits once (:func:`extract_features`), train a fresh
  multinomial logistic regression on them (:func:`train_linear_probe`, the
  JAX recipe step for step) and report top-1/5 (:func:`fit_and_score`).
  The features stay in host memory and reach the card one minibatch at a
  time, as in JAX: at ImageNet scale they are ~10 GB.

Data parallel (JAX's ``encoder_extractor_spmd`` and
``extract_features_spmd``): each rank extracts its share, its shard of a
split or, where every rank holds the whole split (the test split without
``--shard-eval``), the batches ``islice(rank, None, world)``, in
lockstep; each round's features are all-gathered and put in the global
order, and the probe fits on the gathered features identically on every
rank.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from byol_tpu_torch.core.precision import Policy, get_policy
from byol_tpu_torch.models.layers import store_in_compute_dtype
from byol_tpu_torch.objectives.metrics import topk_accuracy

# ImageNet channel statistics (torchvision convention) behind the
# ``normalize_inputs`` switch
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device, dtype: torch.dtype,
                    rgb: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean/std constants of :func:`normalize_images`, made once per
    device and dtype: a copy from host memory inside the forward would
    synchronise the step and cannot be captured in a CUDA graph.  Normal
    (not inference) tensors, so a training step may use them too."""
    with torch.inference_mode(False):
        mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device)
        std = torch.tensor(IMAGENET_STD, dtype=dtype, device=device)
        if not rgb:
            mean, std = mean.mean(), std.mean()
    return mean, std


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """Standardize NHWC [0,1] pixels with the ImageNet mean/std; non-RGB
    inputs use the channel-averaged statistics."""
    mean, std = _imagenet_stats(x.device, x.dtype,
                                x.shape[-1] == len(IMAGENET_MEAN))
    return (x - mean) / std


def _prep_inputs(x: torch.Tensor, policy: Policy,
                 normalize: bool) -> torch.Tensor:
    """Cast to the trained compute dtype and, with ``normalize``, apply the
    same ImageNet standardization the train step used."""
    xc = policy.cast_to_compute(x)
    return normalize_images(xc) if normalize else xc


def frozen_representation_fn(net, *, half: bool = False,
                             normalize: bool = False) -> Callable:
    """``images (B, H, W, C) -> (B, D)`` fp32 representations of ``net``'s
    backbone, in eval mode and without autograd.  ``net`` holds its weights
    (where the JAX function takes ``params``/``batch_stats``)."""
    policy = get_policy(half)
    net.eval()

    def represent(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return net.represent(_prep_inputs(x, policy, normalize)).float()

    return represent


@dataclasses.dataclass
class LinearEvalResult:
    top1: float
    top5: float
    train_acc: float
    num_train: int
    num_test: int


def extract_features(apply_fn: Callable, batches: Iterator[Dict[str, Any]],
                     *, view: str = "view1",
                     watchdog: Optional[Any] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Run the frozen encoder over a loader; returns (features, labels).

    ``apply_fn(images) -> representations`` takes and returns host arrays
    (:func:`encoder_apply_fn`).  Batches share the loader's fixed shape
    except a possible final remainder, which is padded here to the first
    batch's rows, so the encoder sees one shape.

    ``watchdog`` (observability.watchdog.Watchdog, optional): petted per
    batch — every ``apply_fn`` call ends in a blocking readback, so a
    wedged card during extraction is caught like a wedged train-epoch
    readback."""
    feats, labels = [], []
    fixed = None
    for batch in batches:
        if watchdog is not None:
            watchdog.pet()
        x = np.asarray(batch[view])
        y = np.asarray(batch["label"])
        n = len(y)
        if fixed is None:
            fixed = n
        if n < fixed:                      # pad the remainder batch
            pad = np.zeros((fixed - n,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad], axis=0)
        f = np.asarray(apply_fn(x))[:n]
        feats.append(f.astype(np.float32))
        labels.append(y)
    return np.concatenate(feats), np.concatenate(labels)


def _cosine_decay(lr: float, decay_steps: int, count: int) -> float:
    """optax ``cosine_decay_schedule(lr, decay_steps)`` at ``count``."""
    frac = min(count, decay_steps) / decay_steps
    return lr * 0.5 * (1.0 + math.cos(math.pi * frac))


def train_linear_probe(train_x: np.ndarray, train_y: np.ndarray,
                       num_classes: int, *, epochs: int = 30,
                       batch_size: int = 1024, lr: float = 0.1,
                       weight_decay: float = 0.0, seed: int = 0,
                       device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Multinomial logistic regression on frozen features; returns (W, b).

    JAX's recipe: zero-initialised ``w``, ``b``; features standardized by
    the train mean and std + 1e-6; ``add_decayed_weights(weight_decay)``
    then SGD with momentum 0.9 (not Nesterov) under a cosine decay from
    ``lr`` to 0 over ``epochs * (n // batch_size)`` steps, counted from 0;
    ``RandomState(seed).permutation(n)`` each epoch, the tail after the
    full batches dropped; the standardization folded back into ``(W, b)``
    so callers apply raw features.  fp32 on ``device`` (the card unless
    the caller asks for the CPU); the features stay in host memory and go
    there one minibatch at a time."""
    device = torch.device(device)
    n, d = train_x.shape
    batch_size = min(batch_size, n)
    steps_per_epoch = max(n // batch_size, 1)
    decay_steps = epochs * steps_per_epoch

    mu = train_x.mean(0, keepdims=True).astype(np.float32)
    sd = (train_x.std(0, keepdims=True) + 1e-6).astype(np.float32)
    mu_d = torch.from_numpy(mu).to(device)              # (1, d) — tiny
    sd_d = torch.from_numpy(sd).to(device)

    w = torch.zeros((d, num_classes), dtype=torch.float32, device=device,
                    requires_grad=True)
    b = torch.zeros((num_classes,), dtype=torch.float32, device=device,
                    requires_grad=True)
    trace = [torch.zeros_like(w), torch.zeros_like(b)]

    rng = np.random.RandomState(seed)
    ys = train_y.astype(np.int64)
    count = 0
    for _ in range(epochs):
        perm = rng.permutation(n)
        for s in range(steps_per_epoch):
            idx = perm[s * batch_size:(s + 1) * batch_size]
            xb = torch.from_numpy(np.ascontiguousarray(train_x[idx])).to(
                device)
            yb = torch.from_numpy(ys[idx]).to(device)
            loss = F.cross_entropy(((xb - mu_d) / sd_d) @ w + b, yb)
            gw, gb = torch.autograd.grad(loss, (w, b))
            step_lr = _cosine_decay(lr, decay_steps, count)
            with torch.no_grad():
                for p, g, m in ((w, gw, trace[0]), (b, gb, trace[1])):
                    g = g + weight_decay * p        # add_decayed_weights
                    m.mul_(0.9).add_(g)             # trace(0.9), in place
                    p.sub_(step_lr * m)
            count += 1

    w_np = w.detach().cpu().numpy()
    b_np = b.detach().cpu().numpy()
    # fold the standardization into (W, b) so callers apply raw features
    w_out = w_np / sd.T
    b_out = b_np - (mu / sd) @ w_np
    return w_out, b_out.reshape(-1)


def fit_and_score(train_x: np.ndarray, train_y: np.ndarray,
                  test_x: np.ndarray, test_y: np.ndarray, num_classes: int,
                  *, epochs: int = 30, lr: float = 0.1, seed: int = 0,
                  device="cuda") -> LinearEvalResult:
    """Fit the probe on extracted features and report top-1/5 (percent)."""
    device = torch.device(device)
    w, b = train_linear_probe(train_x, train_y, num_classes,
                              epochs=epochs, lr=lr, seed=seed, device=device)
    wd = torch.from_numpy(w).to(device)
    bd = torch.from_numpy(b).to(device)

    def acc(x, y, chunk: int = 8192):
        """Chunked scoring: never materializes the full (N, classes)
        logits (5+ GB at ImageNet scale) on the card."""
        hits1 = hits5 = total = 0.0
        for lo in range(0, len(y), chunk):
            xb = torch.from_numpy(np.ascontiguousarray(
                x[lo:lo + chunk], dtype=np.float32)).to(device)
            yb = torch.from_numpy(y[lo:lo + chunk].astype(np.int64)).to(
                device)
            t1, t5 = topk_accuracy(xb @ wd + bd, yb)
            m = len(yb)
            hits1 += float(t1) * m
            hits5 += float(t5) * m
            total += m
        return hits1 / total, hits5 / total

    top1, top5 = acc(test_x, test_y)
    train_top1, _ = acc(train_x, train_y)
    return LinearEvalResult(top1=top1, top5=top5, train_acc=train_top1,
                            num_train=len(train_y), num_test=len(test_y))


def linear_eval(apply_fn: Callable, train_batches: Iterator,
                test_batches: Iterator, num_classes: int, *,
                epochs: int = 30, lr: float = 0.1, seed: int = 0,
                watchdog: Optional[Any] = None,
                device="cuda") -> LinearEvalResult:
    """Full offline protocol: extract -> fit probe -> report top-1/5."""
    train_x, train_y = extract_features(apply_fn, train_batches,
                                        watchdog=watchdog)
    test_x, test_y = extract_features(apply_fn, test_batches,
                                      watchdog=watchdog)
    if watchdog is not None:
        # extraction (the readback windows the watchdog covers) is done;
        # the probe fit has no pet points, and an armed deadline would
        # kill a healthy run
        watchdog.stop()
    return fit_and_score(train_x, train_y, test_x, test_y, num_classes,
                         epochs=epochs, lr=lr, seed=seed, device=device)


def encoder_apply_fn(net, state, *, half: bool = False,
                     normalize: bool = False) -> Callable:
    """Frozen-encoder feature extractor from a TrainState: ``net`` (a net
    of the state's architecture, e.g. ``build_net(rcfg)``) takes the
    state's online params and BatchNorm statistics (not the Polyak copy,
    as the JAX function takes ``state.params``), on the state's device,
    its kernels stored in the compute dtype.  The returned function maps
    host images (B, H, W, C) to host fp32 features (B, D)."""
    device = state.params.device
    net = net.to(device)
    net.load_state_dict({**state.tree(state.params), **state.batch_stats()},
                        strict=True)
    represent = frozen_representation_fn(store_in_compute_dtype(net),
                                         half=half, normalize=normalize)

    def apply(x: np.ndarray) -> np.ndarray:
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return represent(xt).cpu().numpy()

    return apply


def encoder_extractor_spmd(net, state, *, half: bool = False,
                           normalize: bool = False) -> Callable:
    """The frozen encoder of one rank for :func:`extract_features_spmd`:
    host images (B, H, W, C) -> fp32 features (B, D) left on the state's
    device, where the all-gather reads them.  It reads the online params
    and BatchNorm statistics, which every layout keeps whole but the
    tensor-parallel heads, whose shards ``net``'s heads are cut to."""
    from byol_tpu_torch.models.byol_net import shard_heads
    device = state.params.device
    net = shard_heads(net, *state.model_axis).to(device)
    net.load_state_dict({**state.tree(state.params), **state.batch_stats()},
                        strict=True)
    represent = frozen_representation_fn(store_in_compute_dtype(net),
                                         half=half, normalize=normalize)

    def apply(x: np.ndarray) -> torch.Tensor:
        return represent(torch.from_numpy(np.ascontiguousarray(x)).to(
            device))

    return apply


def extract_features_spmd(apply_fn: Callable,
                          batches: Iterator[Dict[str, Any]], *,
                          host_batch: int, view: str = "view1",
                          replicated_data: bool = False,
                          sample_shape: Optional[Tuple[int, ...]] = None,
                          watchdog: Optional[Any] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Extraction over the data axis: every rank runs this in lockstep on
    its share and gets the same (features, labels) of every rank.

    Each round, each rank pads its batch to ``host_batch`` rows (all pad
    where it has drained: the zero images of ``sample_shape``), encodes
    it, and the round's features and labels (-1 on pad rows) are
    all-gathered.  ``replicated_data``: every rank iterates the SAME
    batches (the whole test split), dealt round-robin, so each is encoded
    once; the result is then in batch order, round by round.  Otherwise
    each rank holds a shard and the result is rank 0's rows, then rank
    1's: for the contiguous shards of the array loaders, the unsharded
    order.  A rank whose iterator raises fails every rank
    (parallel/lockstep.py)."""
    from byol_tpu_torch.parallel import collectives, mesh
    from byol_tpu_torch.parallel.lockstep import lockstep_iter
    rank, world = mesh.process_info()
    it = iter(batches)
    if replicated_data and world > 1:
        it = itertools.islice(it, rank, None, world)
    rounds = []                      # per round: (world * B, D), (world * B,)
    for batch in lockstep_iter(it, lambda: None):
        if watchdog is not None:
            watchdog.pet()
        if batch is None:
            if sample_shape is None:
                raise ValueError("extract_features_spmd: a rank drained "
                                 "early and has no sample_shape to pad "
                                 "from")
            x = np.zeros((0,) + tuple(sample_shape), np.float32)
            y = np.zeros((0,), np.int64)
        else:
            x = np.asarray(batch[view])
            y = np.asarray(batch["label"], np.int64)
        n = len(y)
        if n > host_batch:
            raise ValueError(f"batch of {n} rows > host_batch {host_batch}")
        x = np.concatenate([x, np.zeros((host_batch - n,) + x.shape[1:],
                                        x.dtype)])
        f = apply_fn(x).float()
        labels = torch.full((host_batch,), -1, dtype=torch.int64,
                            device=f.device)
        labels[:n] = torch.from_numpy(y).to(f.device)
        rounds.append((collectives.all_gather(f.contiguous()).cpu(),
                       collectives.all_gather(labels).cpu()))
    if not rounds:
        raise ValueError("extraction produced no features: every rank's "
                         "iterator was empty")
    feats = torch.stack([f for f, _ in rounds]).view(
        len(rounds), world, host_batch, -1)
    labels = torch.stack([y for _, y in rounds]).view(len(rounds), world,
                                                      host_batch)
    if not replicated_data:          # rank-major: each rank's shard whole
        feats, labels = feats.transpose(0, 1), labels.transpose(0, 1)
    keep = labels.reshape(-1) >= 0
    return (feats.reshape(-1, feats.shape[-1])[keep].numpy(),
            labels.reshape(-1)[keep].numpy().astype(np.int32))


def run_linear_eval_from_cfg(cfg, state, *, loader=None, mesh=None,
                             epochs: int = 30, seed: int = 0,
                             watchdog: Optional[Any] = None
                             ) -> LinearEvalResult:
    """Convenience entry point: rebuild the encoder from ``cfg``, extract
    resize-only features for the train/test splits, fit + score the probe
    on the state's device.  ``loader`` is the training run's bundle (built
    from ``cfg`` when not given).  Inside a process group (or given a
    ``mesh``, parallel/mesh.py::MeshSpec) every rank calls it: the
    extraction is :func:`extract_features_spmd`'s, and every rank fits the
    same probe on the gathered features."""
    from byol_tpu_torch.core.config import resolve
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.parallel import mesh as mesh_lib
    from byol_tpu_torch.training.build import build_net

    device = state.params.device
    if loader is None:
        loader = get_loader(cfg, device=device)
    rcfg = resolve(cfg, num_train_samples=loader.num_train_samples,
                   num_test_samples=loader.num_test_samples,
                   output_size=loader.output_size,
                   input_shape=loader.input_shape)
    if mesh is None and not mesh_lib.is_initialized():
        apply_fn = encoder_apply_fn(build_net(rcfg), state,
                                    half=cfg.device.half,
                                    normalize=cfg.parity.normalize_inputs)
        return linear_eval(apply_fn, loader.train_eval_loader,
                           loader.test_loader, loader.output_size,
                           epochs=epochs, seed=seed, watchdog=watchdog,
                           device=device)
    if mesh is not None:
        mesh.resolved()              # the data axis is the world
    apply_fn = encoder_extractor_spmd(build_net(rcfg), state,
                                      half=cfg.device.half,
                                      normalize=cfg.parity.normalize_inputs)
    host_batch = mesh_lib.local_rows(rcfg.global_batch_size)
    train_x, train_y = extract_features_spmd(
        apply_fn, loader.train_eval_loader, host_batch=host_batch,
        sample_shape=loader.input_shape, watchdog=watchdog)
    # the whole test split on every rank (Quirk Q9) is dealt round-robin;
    # a sharded one is extracted shard by shard
    test_x, test_y = extract_features_spmd(
        apply_fn, loader.test_loader, host_batch=host_batch,
        replicated_data=not loader.eval_sharded,
        sample_shape=loader.input_shape, watchdog=watchdog)
    if len(test_y) != loader.num_test_samples:
        raise ValueError(
            f"linear eval gathered {len(test_y)} test samples but the "
            f"loader reports num_test_samples={loader.num_test_samples}: "
            f"the bundle's eval_sharded flag ({loader.eval_sharded}) does "
            "not match how its test iterator is sharded")
    if watchdog is not None:
        watchdog.stop()
    return fit_and_score(train_x, train_y, test_x, test_y,
                         loader.output_size, epochs=epochs, seed=seed,
                         device=device)
