"""BYOL pretraining: ``train_step(state, batch)`` of ``byol_tpu_torch``.

Set-up builds the program's train state from the configuration's flags
(``byol_tpu_torch.cli`` -> ``core.config.resolve`` ->
``training.build.setup_training``) and the step with the benchmark's view
draws (``training.steps.make_train_step(..., draw_views=...)``), copies
the benchmark's weights in, and drives the step through its first
``check_steps`` optimizer steps on distinct batches: the steps that the
reference follows after the window.  The state's schedule counters start
at the end of the learning rate's warmup, where a run spends most of its
steps (at the warmup's start the rate is 0, and the first steps would
move the weights by less than float32 resolves).  The first of them compiles and
warms every shape.  The window then runs whole optimizer steps on the
same object, cycling through the batches, until ``seconds`` have passed;
``train_img_s`` is the images of those steps over the time from the first
one's dispatch to the last one's completion.  With ``trace``, the last
``profile_steps`` steps of the window run under the profiler, after a
synchronisation, so the traced sub-window holds exactly those steps.

The inputs are the benchmark's, made from the seed: uint8 images and
labels on the device (``distinct_batches`` batches), the view draws of
every (step, microbatch), and the weights (harness/weights.py).
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict

import torch

from harness import checks, weights as weights_lib
from harness.trace import Capture, attach, reduce
from reference import augment, byol, nets
from reference.precision import FP32, strict_fp32


def reference_conf(conf) -> Dict[str, Any]:
    """The configuration with the traffic's batch and accumulation."""
    t = conf["traffic"]
    return {**conf, "batch_size": t["batch_size"],
            "optimizer": {**conf["optimizer"],
                          "accum_steps": t["accum_steps"]}}


def inputs(conf, seed: int, device) -> Dict[str, Any]:
    """Images, labels and view draws of every distinct batch."""
    t = conf["traffic"]
    n, b, k = t["distinct_batches"], t["batch_size"], t["accum_steps"]
    h = w = conf["image_size"]
    gen = torch.Generator(device=device)
    gen.manual_seed(weights_lib.stream_seed(seed, "images"))
    images = torch.randint(0, 256, (n, b, h, w, 3), dtype=torch.uint8,
                           device=device, generator=gen)
    labels = torch.randint(0, conf["num_classes"], (n, b), device=device,
                           generator=gen)
    cpu = torch.Generator().manual_seed(weights_lib.stream_seed(seed,
                                                                "draws"))
    draws = [[augment.draw_views(cpu, b // k, h, w) for _ in range(k)]
             for _ in range(n)]
    return {"batches": [{"images": images[i], "label": labels[i]}
                        for i in range(n)], "draws": draws}


def build_program(conf, seed: int, device, data, recorder):
    """The program's train state and step, the benchmark's weights in."""
    from byol_tpu_torch import cli
    from byol_tpu_torch.core.config import resolve
    from byol_tpu_torch.core.precision import get_policy
    from byol_tpu_torch.data.device_augment import ViewParams
    from byol_tpu_torch.training import build
    from byol_tpu_torch.training.steps import make_train_step

    t = conf["traffic"]
    flags = conf["flags"] + t["flags"] + [
        "--batch-size", str(t["batch_size"]),
        "--accum-steps", str(t["accum_steps"]),
        "--seed", str(seed % (2 ** 31 - 1))]
    cfg = cli.config_from_args(cli.build_parser().parse_args(flags))
    ds, size = conf["dataset"], conf["image_size"]
    rcfg = resolve(cfg, num_train_samples=ds["train_samples"],
                   num_test_samples=ds["test_samples"],
                   output_size=conf["num_classes"],
                   input_shape=(size, size, 3))
    _, state, _, _, schedule = build.setup_training(rcfg, device)
    draws = data["draws"]

    def draw_views(step, b, h, w, microbatch):
        with recorder.span("bench/draw_views"):
            pair = draws[step % len(draws)][microbatch]
            return tuple(ViewParams(*(f[:b] for f in v)) for v in pair)

    tx, _ = build.build_tx(rcfg)
    step = make_train_step(tx, build.step_config(rcfg), schedule,
                           get_policy(cfg.device.half), draw_views=draw_views)
    shapes = dict(zip(state.names, (tuple(s) for s in state.shapes)))
    if shapes != nets.param_shapes(conf):
        raise RuntimeError("the program's parameters differ from the "
                           "configuration's: "
                           f"{sorted(set(shapes) ^ set(nets.param_shapes(conf)))[:6]}")
    w = weights_lib.make(seed, shapes, conf["init"], device)
    with torch.no_grad():
        for name, view in state.tree(state.params).items():
            view.copy_(w[name])
        state.target.copy_(state.params)
        if state.polyak is not None:
            state.polyak.copy_(state.params)
        for name, buf in state.batch_stats().items():
            buf.fill_(1.0 if name.endswith("running_var") else 0.0)
    state.count = state.ema_step = byol.warmup_steps(reference_conf(conf))
    return state, step


def first_steps(state, step, data, n: int, recorder) -> Dict[str, Any]:
    """Drives ``n`` optimizer steps and reads what the check compares:
    each step's loss, the first gradient's leaf norms (the flat gradient
    buffer as the update read it), each leaf's change over the ``n``
    steps of the parameters, the target (EMA) and the Polyak average
    (all three start as the same weights), and each leaf's momentum norm
    after them.  Returns the readings and the last step's seconds."""
    before = state.params.clone()
    losses, first_grad, seconds = [], None, 0.0
    batches = data["batches"]
    for s in range(n):
        t0 = time.perf_counter()
        with recorder.span("bench/train_step"):
            metrics = step(state, batches[state.step % len(batches)])
        losses.append(float(metrics["loss_mean"]))
        seconds = time.perf_counter() - t0
        if s == 0:
            first_grad = _leaf_norms(state, state.grads)
    out = {"loss": losses, "first_grad": first_grad,
           "change": _leaf_norms(state, state.params - before),
           "target_change": _leaf_norms(state, state.target - before),
           "momentum": _leaf_norms(state, state.momentum),
           "step_seconds": seconds}
    if state.polyak is not None:
        out["polyak_change"] = _leaf_norms(state, state.polyak - before)
    return out


def _leaf_norms(state, buf) -> Dict[str, float]:
    norms = torch.stack(torch._foreach_norm(state.leaves(buf))).tolist()
    return dict(zip(state.names, norms))


def reference_readings(conf, seed: int, device, data, n: int, cast=FP32,
                       rows: slice = slice(None)) -> Dict[str, Any]:
    rconf = reference_conf(conf)
    w = weights_lib.make(seed, nets.param_shapes(conf), conf["init"], device)

    def draws(step, microbatch):
        return tuple(tuple(f.to(device) for f in v)
                     for v in data["draws"][step][microbatch])

    with strict_fp32():
        return byol.train_steps(w, data["batches"][:n], draws, rconf, cast,
                                start=byol.warmup_steps(rconf), rows=rows)


def run(conf, seed: int, seconds: float, trace: bool, device,
        recorder) -> Dict[str, Any]:
    t = conf["traffic"]
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    data = inputs(conf, seed, device)
    state, step = build_program(conf, seed, device, data, recorder)
    n_check = t["check_steps"]
    prog = first_steps(state, step, data, n_check, recorder)
    batch = t["batch_size"]
    batches = data["batches"]

    def one():
        with recorder.span("bench/train_step"):
            step(state, batches[state.step % len(batches)])

    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    profiled = t["profile_steps"] if trace else 0
    capture = Capture() if profiled else None
    if profiled and cuda:
        attach()
    sync()
    setup_done = time.perf_counter()
    t0, steps = setup_done, 0
    # untraced: whole steps until the window's seconds have passed; traced:
    # the last profile_steps steps (estimated from the set-up's last step)
    # run under the profiler after a synchronisation
    lead = seconds - profiled * prog["step_seconds"]
    while time.perf_counter() - t0 < (lead if profiled else seconds):
        one()
        steps += 1
    if profiled:
        with recorder.span("bench/sync"):
            sync()
        capture.start()
        for _ in range(profiled):
            one()
        steps += profiled
    with recorder.span("bench/sync"):
        sync()
    t_end = time.perf_counter()
    if capture is not None:
        capture.stop()
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    img_s = steps * batch / (t_end - t0)
    traced = reduce(capture, recorder.spans) if capture is not None else None
    del state, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    ref = reference_readings(conf, seed, device, data, n_check)
    print(f"train: {steps} steps of {batch} images in {t_end - t0:.3f} s; "
          f"the reference's {n_check} steps took "
          f"{time.perf_counter() - r0:.1f} s", file=sys.stderr)
    readings = checks.train_readings(prog, ref)
    print(f"train: worst leaves {readings['_grad_leaf']} (gradient), "
          f"{readings['_change_leaf']} (change), "
          f"{readings['_target_leaf']} (target), "
          f"{readings.get('_polyak_leaf')} (Polyak), "
          f"{readings['_momentum_leaf']} (momentum); "
          f"{readings['_leaves_left_out']} leaves with no gradient left "
          "out of the change", file=sys.stderr)
    return {"setup_done": setup_done, "attempted": steps, "failed": 0,
            "readings": readings,
            "memory_peak_bytes": max(peak_setup, peak_window),
            "trace": traced,
            "e2e": {"train_img_s": img_s},
            "layer": {"img_s": img_s, "steps_traced": profiled,
                      "peak_window_bytes": peak_window,
                      "flat_elements": None}}
