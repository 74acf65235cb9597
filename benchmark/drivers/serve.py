"""The embedding service: ``EmbeddingService.submit`` of ``byol_tpu_torch``
under open-loop traffic.

Set-up builds the service with ``serving.service.build_service`` from the
configuration's flags and the traffic's ``ServeConfig`` fields, copies the
benchmark's weights into the served encoder, starts it (the engine
captures every bucket's CUDA graph), makes the pool of images from the
seed and sends bursts that fill every bucket (:func:`warm`).  The window
sends one request at each time of the schedule (harness/traffic.py) from
this thread, whether or not earlier ones were answered; a request that
finds the queue full waits for room, so that above the service's capacity
the sender runs behind, sends nothing once the window has closed, and the
window measures the rate answered.  A second thread collects the answers
in order and stamps each when the benchmark holds it.  A request's
latency runs from the time it was due, so a late send counts against it.
After the last send every answer is awaited, up to a minute, and every
answer is compared with the reference's embedding of its image.  With
``trace``, the last ``profile_seconds`` of the schedule run under the
profiler.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Any, Dict

import numpy as np
import torch

from harness import checks, stats, traffic, weights as weights_lib
from harness.trace import Capture, attach, reduce
from reference import byol, nets
from reference.precision import FP32, strict_fp32

WAIT_AFTER_S = 60.0
# how long a request waits for room in a full queue before it is refused
SUBMIT_WAIT_S = 60.0
# torch's CPU work (the staging copies) runs on one thread: more threads
# spin beside the sender's, the collector's and the service's on the
# host's cores, and widen the spread of the rate answered from process to
# process (PERF.md)
TORCH_THREADS = 1
# the interpreter's thread switch interval: a thread that waits for the
# GIL waits up to this long (Python's default is 5 ms), and the sender,
# the collector and the service's worker hand the GIL to each other on
# every request and batch
SWITCH_INTERVAL_S = 0.0005


def served_net(service):
    """The module the engine's representation function closes over."""
    cells = getattr(service.engine.represent, "__closure__", None) or ()
    nets_found = [c.cell_contents for c in cells
                  if isinstance(c.cell_contents, torch.nn.Module)]
    if len(nets_found) != 1:
        raise RuntimeError("cannot find the served network in the engine's "
                           "representation function")
    return nets_found[0]


def build(conf, seed: int, device, recorder):
    from byol_tpu_torch import cli
    from byol_tpu_torch.serving.service import ServeConfig, build_service

    flags = conf["flags"] + conf["traffic"]["flags"] + [
        "--seed", str(seed % (2 ** 31 - 1))]
    cfg = cli.config_from_args(cli.build_parser().parse_args(flags))
    torch.set_num_threads(TORCH_THREADS)
    sys.setswitchinterval(SWITCH_INTERVAL_S)
    service = build_service(
        cfg, ServeConfig(num_classes=conf["num_classes"],
                         **conf["traffic"]["serve_config"]),
        device=str(device), recorder=recorder)
    net = served_net(service)
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    if shapes != nets.param_shapes(conf):
        raise RuntimeError("the served network's parameters differ from the "
                           "configuration's")
    w = weights_lib.make(seed, shapes, conf["init"], device)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(w[name])
    return service


WARM_BURSTS = (64, 48, 24, 12, 6, 3)


def warm(service, pool: np.ndarray) -> None:
    """Set-up traffic: bursts of requests that coalesce into batches of
    every bucket, so that what a bucket's first batch sets up (the
    engine's pinned staging buffers are allocated then, not in its
    warmup) happens before the window, three times over."""
    for _ in range(3):
        for burst in WARM_BURSTS:
            reqs = [service.submit(pool[i % len(pool)], timeout=10.0)
                    for i in range(burst)]
            for r in reqs:
                r.result(60.0)


def pool_images(conf, seed: int, device) -> np.ndarray:
    size, n = conf["image_size"], conf["traffic"]["pool"]
    gen = torch.Generator(device=device)
    gen.manual_seed(weights_lib.stream_seed(seed, "pool"))
    return torch.rand((n, size, size, 3), generator=gen,
                      device=device).cpu().numpy()


def reference_embeddings(conf, seed: int, device, pool: np.ndarray,
                         cast=FP32) -> np.ndarray:
    w = weights_lib.make(seed, nets.param_shapes(conf), conf["init"], device)
    with strict_fp32():
        return byol.embed(w, torch.from_numpy(pool).to(device), conf,
                          cast).cpu().numpy()


def _collect(inbox: "queue.Queue", w: Dict[str, Any], deadline: list
             ) -> None:
    """Waits for each request in the order sent (batches complete in that
    order), stamps its answer and keeps only numbers: a window holds tens
    of thousands of requests, and keeping them alive would slow the
    collector's process with garbage collection."""
    while True:
        item = inbox.get()
        if item is None:
            return
        i, req = item
        emb = None
        while emb is None:
            try:
                emb = req.result(0.5)
            except TimeoutError as e:
                if time.perf_counter() > deadline[0]:
                    w["errors"].append(f"request {i}: {e}")
                    break
            except Exception as e:  # noqa: BLE001 -- counted as unanswered
                w["errors"].append(f"request {i}: {type(e).__name__}: {e}")
                break
        if emb is not None:
            w["done"][i] = time.perf_counter()
            w["answers"][i] = emb[0]
            marks = req.marks
            if "coalesce" in marks:
                w["queue_ms"][i] = 1e3 * (marks["coalesce"] - marks["enqueue"])


def _profile(capture: Capture, start: float, stop: float) -> None:
    """Runs the profiler from ``start`` to ``stop`` (perf clock) on its own
    thread, so that its start and stop never stall the sender."""
    time.sleep(max(start - time.perf_counter(), 0.0))
    capture.start()
    time.sleep(max(stop - time.perf_counter(), 0.0))
    capture.stop()


def send(service, pool: np.ndarray, dim: int, rate: float, seconds: float,
         seed: int, recorder, profile_seconds: float = 0.0
         ) -> Dict[str, Any]:
    """One window of open-loop traffic; returns per-request times and
    answers of the requests sent (those attempted)."""
    due = traffic.poisson_schedule(rate, seconds, seed)
    n = len(due)
    w: Dict[str, Any] = {
        "seconds": seconds, "index": traffic.pool_indices(n, len(pool), seed),
        "done": np.full(n, np.nan), "answers": np.zeros((n, dim), np.float32),
        "queue_ms": np.full(n, np.nan), "late": np.zeros(n), "errors": [],
        "capture": Capture() if profile_seconds > 0 else None}
    index = w["index"]
    inbox: "queue.Queue" = queue.Queue()
    deadline = [float("inf")]
    collector = threading.Thread(target=_collect, name="bench_collect",
                                 args=(inbox, w, deadline), daemon=True)
    collector.start()
    t0 = time.perf_counter() + 0.05
    w["t0"], w["due"] = t0, t0 + due
    profiler = None
    if w["capture"] is not None:
        profiler = threading.Thread(
            target=_profile, name="bench_profile",
            args=(w["capture"], t0 + seconds - profile_seconds, t0 + seconds))
        profiler.start()
    late, sent = w["late"], n
    for i in range(n):
        at = t0 + due[i]
        now = time.perf_counter()
        if at > now:
            time.sleep(at - now)
            now = time.perf_counter()
        elif now >= t0 + seconds:
            sent = i
            break
        late[i] = now - at
        try:
            with recorder.span("bench/submit"):
                req = service.submit(pool[index[i]], timeout=SUBMIT_WAIT_S)
        except Exception as e:  # noqa: BLE001 -- refused: unanswered
            w["errors"].append(f"request {i}: {type(e).__name__}: {e}")
            continue
        inbox.put((i, req))
    if profiler is not None:
        profiler.join()
    deadline[0] = t0 + seconds + WAIT_AFTER_S
    inbox.put(None)
    collector.join()
    for key in ("index", "done", "answers", "queue_ms", "late", "due"):
        w[key] = w[key][:sent]
    return w


def run(conf, seed: int, seconds: float, trace: bool, device,
        recorder) -> Dict[str, Any]:
    t = conf["traffic"]
    if trace and device.type == "cuda":
        attach()
    service = build(conf, seed, device, recorder)
    service.start()
    pool = pool_images(conf, seed, device)
    warm(service, pool)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_done = time.perf_counter()
    w = send(service, pool, nets.feature_dim(conf["arch"]),
             conf["cell"]["rate_per_s"], seconds, seed, recorder,
             t["profile_seconds"] if trace else 0.0)
    service.stop()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    traced = (reduce(w["capture"], recorder.spans)
              if w["capture"] is not None else None)
    answered = ~np.isnan(w["done"])
    latency = np.where(answered, w["done"] - w["due"], np.inf) * 1e3
    # the profiler slows the host: a traced run's tail is that of the
    # requests due before its profiled sub-window
    profiled = w["t0"] + seconds - (t["profile_seconds"] if trace else 0.0)
    before = latency[w["due"] < profiled]
    in_window = answered & (w["done"] <= w["t0"] + seconds)
    rows = t["rows"]
    queue_ms = w["queue_ms"][~np.isnan(w["queue_ms"])].tolist()
    del service
    ref = reference_embeddings(conf, seed, device, pool)
    gaps = checks.embed_gaps(w["answers"][answered], w["index"][answered],
                             ref)
    n = len(latency)
    print(f"serve: {n} requests at {conf['cell']['rate_per_s']}/s, "
          f"{int(answered.sum())} answered, latency p50 "
          f"{stats.percentile(latency, 50):.3f} ms, p99 "
          f"{stats.percentile(latency, 99):.3f} ms; the sender ran late by "
          f"{np.median(w['late']) * 1e3:.3f} ms (median), "
          f"{w['late'].max() * 1e3:.3f} ms (most); first errors "
          f"{w['errors'][:3]}", file=sys.stderr)
    return {"setup_done": setup_done, "attempted": n,
            "failed": int(n - answered.sum()),
            "readings": {"embed_gap": float(gaps.max()) if len(gaps)
                         else float("inf"),
                         "unanswered": float(n - answered.sum())},
            "memory_peak_bytes": peak, "trace": traced,
            "e2e": {"serve_img_s": float(in_window.sum()) * rows / seconds,
                    "serve_p50_ms": stats.percentile(latency, 50)},
            "layer": {"img_s": float(in_window.sum()) * rows / seconds,
                      "p99_ms": stats.percentile(before, 99),
                      "queue_ms": queue_ms}}
