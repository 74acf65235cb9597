"""``python -m byol_tpu_torch serve`` — stand up the embedding service.

Counterpart of byol_tpu/serving/cli.py, with the same spellings for the
flags it keeps.  Net-defining flags: --arch, --attn-impl, --pooling,
--image-size-override, --half/--no-half, --normalize-inputs, --seed,
--head-latent-size, --projection-size, --num-classes.  Serving knobs:

    --min-bucket/--max-batch   the power-of-two bucket vocabulary
    --max-queue           bounded-queue depth (backpressure past it)
    --max-wait-ms         coalescing flush deadline
    --pipeline off|on     worker dispatch pipelining (on)
    --stats-interval      seconds between stats windows
    --http HOST:PORT      the wire front end (serving/net/): POST
                          /v1/embed + GET /healthz /readyz /statsz,
                          X-Deadline-Ms admission budgets, 429/503
                          backpressure, graceful drain on SIGTERM.  Port 0
                          binds an ephemeral port; the bound address is
                          printed.  Empty = in-process only
    --http-deadline-ms    default per-request budget when the client
                          sends no X-Deadline-Ms
    --drain-grace-s       seconds /readyz answers 503 BEFORE in-flight
                          waiting begins: the window a load balancer's
                          readiness prober needs to evict this replica
    --smoke N             drive N synthetic requests from --smoke-streams
                          closed-loop client threads, print the stats line,
                          and exit NONZERO when any request fails — over
                          the WIRE (one EmbedClient per stream, with the
                          readiness and drain assertions) when --http is
                          given, in-process otherwise
    --no-cuda             run on the CPU; without it a machine with no card
                          exits nonzero (there is no silent CPU fallback)

    --checkpoint DIR      restore the encoder from a training run of the
                          port or of the JAX package (its orbax
                          checkpoints; only their params and batch_stats
                          are read): DIR is ``<model-dir>/<run name>``,
                          the directory holding ``ckpt-N/`` and
                          ``meta.json``; the net-defining flags must match
                          the training run's.  Without it the encoder is random-init
                          from --seed (embeddings are meaningless; compute
                          is identical), and a line says so
    --restore-best        the best-metric checkpoint, not the last
    --serve-events PATH   the run log (run_header, serve_stats windows,
                          run_end; the JAX event schema); default
                          <--log-dir>/serve.jsonl
    --serve-trace PATH    Chrome trace of the serving flight recorder
                          (per-batch serve/batch spans with the requests'
                          trace ids; engine stage/dispatch/readback),
                          written at exit; default
                          <--log-dir>/serve_trace.json, 'off' records none

Without --smoke the process serves until SIGTERM/SIGINT, then drains:
/readyz flips to 503 at once, --drain-grace-s elapses, accepted requests
complete, the listener closes, and the service stops — every accepted
request resolves before exit.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Callable, List, Optional, Tuple


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m byol_tpu_torch serve")
    m = p.add_argument_group("model")
    m.add_argument("--arch", type=str, default="resnet50")
    m.add_argument("--attn-impl", type=str, default="dense",
                   choices=("dense", "flash", "ring"),
                   help="ViT attention backend")
    m.add_argument("--pooling", type=str, default="cls",
                   choices=("cls", "gap"), help="ViT feature pooling")
    m.add_argument("--image-size-override", type=int, default=224)
    m.add_argument("--projection-size", type=int, default=256)
    m.add_argument("--head-latent-size", type=int, default=4096)
    m.add_argument("--num-classes", type=int, default=10,
                   help="probe-head width the weights trained with")
    d = p.add_argument_group("device")
    d.add_argument("--seed", type=int, default=1234)
    d.add_argument("--half", action="store_true", default=True,
                   help="bf16 compute policy")
    d.add_argument("--no-half", dest="half", action="store_false")
    d.add_argument("--normalize-inputs",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="standardize pixels with the ImageNet mean/std")
    d.add_argument("--no-cuda", action="store_true",
                   help="run on the CPU")
    s = p.add_argument_group("serving")
    s.add_argument("--checkpoint", type=str, default="",
                   help="checkpoint directory of a training run of the "
                        "port or of the JAX package (<model-dir>/<run "
                        "name>, holding ckpt-N/ and meta.json); empty = "
                        "random-init encoder "
                        "(smoke/bench only)")
    s.add_argument("--restore-best", action="store_true",
                   help="restore the best-metric checkpoint, not the last")
    s.add_argument("--min-bucket", type=int, default=8,
                   help="smallest pad-to bucket (power of two)")
    s.add_argument("--max-batch", type=int, default=64,
                   help="largest bucket = the coalescing ceiling "
                        "(power of two)")
    s.add_argument("--max-queue", type=int, default=256,
                   help="bounded request queue depth; submits past it "
                        "get backpressure")
    s.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="coalescing flush deadline per batch")
    s.add_argument("--pipeline", choices=("off", "on"), default="on",
                   help="worker dispatch pipelining: 'on' lets the host "
                        "prepare batch i+1 while the card computes batch i")
    s.add_argument("--http", type=str, default="",
                   help="bind the wire front end at HOST:PORT (POST "
                        "/v1/embed, GET /healthz|/readyz|/statsz); port 0 "
                        "binds an ephemeral port; empty = in-process "
                        "submit() only")
    s.add_argument("--http-deadline-ms", type=float, default=30_000.0,
                   help="default admission budget for requests without "
                        "an X-Deadline-Ms header")
    s.add_argument("--drain-grace-s", type=float, default=0.5,
                   help="seconds /readyz serves 503 before the drain "
                        "waits out in-flight requests (load-balancer "
                        "eviction window)")
    s.add_argument("--stats-interval", type=float, default=10.0,
                   help="seconds between stats windows")
    s.add_argument("--log-dir", type=str, default="./runs",
                   help="where --serve-events and --serve-trace go by "
                        "default")
    s.add_argument("--serve-events", type=str, default="",
                   help="serve_stats JSONL path (default "
                        "<log-dir>/serve.jsonl)")
    s.add_argument("--serve-trace", type=str, default="",
                   help="Chrome-trace JSON written at shutdown from the "
                        "serving flight recorder; default "
                        "<log-dir>/serve_trace.json, 'off' disables "
                        "recording entirely")
    s.add_argument("--smoke", type=int, default=0,
                   help="drive N synthetic requests through the service "
                        "(over the wire when --http is given), print "
                        "stats, exit nonzero on ANY failed request")
    s.add_argument("--smoke-streams", type=int, default=4,
                   help="concurrent client threads for --smoke")
    return p


def config_from_args(args: argparse.Namespace):
    from byol_tpu_torch.core.config import (Config, DeviceConfig,
                                            ModelConfig, ParityConfig,
                                            TaskConfig)
    return Config(
        task=TaskConfig(image_size_override=args.image_size_override),
        model=ModelConfig(arch=args.arch,
                          projection_size=args.projection_size,
                          head_latent_size=args.head_latent_size,
                          attn_impl=args.attn_impl, pooling=args.pooling),
        device=DeviceConfig(seed=args.seed, half=args.half),
        parity=ParityConfig(normalize_inputs=args.normalize_inputs))


def serve_observers(events_path: str, trace: str
                    ) -> Tuple[Any, Any, Callable[[], Optional[int]]]:
    """-> (run log, span recorder, export): the recorder is NULL when
    ``trace`` is 'off', and ``export()`` writes its ring to ``trace`` as a
    Chrome trace (returning the span count; None when off or when the
    write failed: the trace is evidence, never a reason to fail
    shutdown)."""
    from byol_tpu_torch.observability import spans as spans_lib
    from byol_tpu_torch.observability.events import RunLog
    recorder = (spans_lib.NULL if trace == "off"
                else spans_lib.SpanRecorder())
    events = RunLog(events_path, best_effort=True)

    def export() -> Optional[int]:
        if not recorder.enabled:
            return None
        try:
            n = spans_lib.export_chrome_trace(recorder.records(), trace,
                                              process_name="byol_serve")
        except OSError as e:
            print(f"serve: trace export failed ({e!r})", file=sys.stderr)
            return None
        print(f"serve: wrote {n} span(s) to {trace}", file=sys.stderr)
        return n
    return events, recorder, export


def _smoke_rc(result, requested: int) -> int:
    """ANY failed or missing request is a nonzero exit."""
    return 0 if (result.failed == 0
                 and result.completed == requested) else 1


def _run_smoke_inproc(service, n_requests: int, n_streams: int, *,
                      seed: int = 0, timeout_s: float = 600.0):
    """Closed-loop smoke through the in-process submit() path."""
    from byol_tpu_torch.serving.net.loadgen import run_closed_loop

    return run_closed_loop(
        lambda idx, img: service.embed(img, timeout=timeout_s),
        service.engine.input_shape, n_requests, n_streams, seed=seed)


def _run_smoke_wire(server, n_requests: int, n_streams: int, *,
                    seed: int = 0, deadline_ms: float = 30_000.0):
    """Closed-loop smoke OVER THE WIRE: one connection-reusing client per
    stream, every request carrying an explicit deadline."""
    from byol_tpu_torch.serving.net.client import EmbedClient
    from byol_tpu_torch.serving.net.loadgen import run_closed_loop

    host, port = server.address
    clients = {}

    def setup(idx: int) -> None:
        clients[idx] = EmbedClient(host, port,
                                   timeout_s=deadline_ms / 1e3 + 5.0,
                                   seed=seed + idx)

    def embed(idx: int, img) -> None:
        clients[idx].embed(img, deadline_ms=deadline_ms,
                           request_id=f"smoke-{idx}")

    try:
        return run_closed_loop(
            embed, server.input_shape, n_requests, n_streams,
            seed=seed, stream_setup=setup)
    finally:
        for c in clients.values():
            c.close()


def _assert_drain_transition(server) -> List[str]:
    """The lifecycle contract, checked over the real wire: ready before the
    drain, readyz 503 and healthz 200 DURING it.  Returns the violations
    (empty = clean); begin_drain is left set — the caller finishes with
    server.drain()."""
    from byol_tpu_torch.serving.net.client import EmbedClient

    host, port = server.address
    problems: List[str] = []
    with EmbedClient(host, port, timeout_s=10.0) as probe:
        status, _ = probe.get("/healthz")
        if status != 200:
            problems.append(f"healthz {status} != 200 before drain")
        status, _ = probe.get("/readyz")
        if status != 200:
            problems.append(f"readyz {status} != 200 before drain")
        server.begin_drain()
        status, _ = probe.get("/readyz")
        if status != 503:
            problems.append(f"readyz {status} != 503 during drain")
        status, _ = probe.get("/healthz")
        if status != 200:
            problems.append(f"healthz {status} != 200 during drain "
                            "(liveness must outlive readiness)")
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    args = build_serve_parser().parse_args(argv)
    import signal
    import threading

    from byol_tpu_torch.core.preflight import (preflight_backend,
                                               resolve_device)
    from byol_tpu_torch.observability.events import run_header_env
    from byol_tpu_torch.serving.meter import serve_log_line
    from byol_tpu_torch.serving.service import ServeConfig, build_service

    # the same killable probe as training: serving startup must fail fast
    # against a wedged GPU runtime, not hang in its first CUDA call
    if not args.no_cuda and not preflight_backend():
        print("byol_tpu_torch serve: accelerator backend unreachable; pass "
              "--no-cuda to serve on CPU.", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.no_cuda)
    except RuntimeError as e:
        print(f"byol_tpu_torch serve: {e}", file=sys.stderr)
        return 2
    http_addr = None
    if args.http:
        from byol_tpu_torch.serving.net.client import parse_address
        try:
            http_addr = parse_address(args.http)
        except ValueError as e:
            print(f"byol_tpu_torch serve: {e}", file=sys.stderr)
            return 2
    cfg = config_from_args(args)
    serve_cfg = ServeConfig(
        min_bucket=args.min_bucket, max_bucket=args.max_batch,
        max_queue=args.max_queue, max_wait_ms=args.max_wait_ms,
        num_classes=args.num_classes,
        stats_interval_s=args.stats_interval,
        pipeline=args.pipeline)
    events, recorder, export_trace = serve_observers(
        args.serve_events or os.path.join(args.log_dir, "serve.jsonl"),
        args.serve_trace or os.path.join(args.log_dir, "serve_trace.json"))
    with events:
        events.emit("run_header",
                    config={**cfg.to_dict(),
                            "serving": {
                                "checkpoint": args.checkpoint,
                                "min_bucket": args.min_bucket,
                                "max_batch": args.max_batch,
                                "max_queue": args.max_queue,
                                "max_wait_ms": args.max_wait_ms,
                                "pipeline": args.pipeline,
                                "http": args.http}},
                    **run_header_env(device))
        try:
            service = build_service(cfg, serve_cfg, device=device,
                                    checkpoint_dir=args.checkpoint,
                                    best=args.restore_best, events=events,
                                    recorder=recorder)
        except (ValueError, NotImplementedError, FileNotFoundError) as e:
            print(f"byol_tpu_torch serve: {e}", file=sys.stderr)
            return 2
        if not args.checkpoint:
            print("serve: no --checkpoint given — serving a RANDOM-init "
                  "encoder from --seed (embeddings are meaningless; "
                  "smoke/bench only)", file=sys.stderr)
        t0 = time.perf_counter()
        service.start()              # warmup: every bucket runs once
        print(f"serve: warm — {service.engine.compile_count} bucket "
              f"shape(s) {list(service.engine.buckets.sizes)} in "
              f"{time.perf_counter() - t0:.1f}s on {device}; accepting "
              f"requests ({service.engine.describe()})")

        stop_signal = threading.Event()
        got = {}
        if not args.smoke:
            # installed before the listener opens: a SIGTERM from a client
            # that saw /readyz 200 must start the drain, not kill the
            # process
            def _on_signal(signum, frame):  # noqa: ARG001 — handler API
                got["signal"] = signal.Signals(signum).name
                stop_signal.set()

            signal.signal(signal.SIGTERM, _on_signal)
            signal.signal(signal.SIGINT, _on_signal)
        server = None
        if http_addr is not None:
            from byol_tpu_torch.serving.net.server import WireServer
            try:
                server = WireServer(
                    service, http_addr[0], http_addr[1],
                    default_deadline_ms=args.http_deadline_ms).start()
            except OSError as e:
                service.stop()
                print(f"byol_tpu_torch serve: cannot bind {args.http}: {e}",
                      file=sys.stderr)
                return 2
            host, port = server.address
            print(f"serve: wire front end at http://{host}:{port} "
                  "(POST /v1/embed, GET /healthz /readyz /statsz)",
                  flush=True)

        if args.smoke:
            problems: List[str] = []
            if server is not None:
                res = _run_smoke_wire(server, args.smoke, args.smoke_streams,
                                      seed=cfg.device.seed,
                                      deadline_ms=args.http_deadline_ms)
                # read the window BEFORE the drain: the final stats emit
                # in stop() resets it
                snap = service.meter.snapshot(time.perf_counter(),
                                              reset=False)
                # the lifecycle assertions ride the smoke: readiness flips
                # to 503 the moment the drain begins, liveness stays 200,
                # and the drain completes cleanly
                problems = _assert_drain_transition(server)
                if not server.drain(grace_s=0.0, timeout_s=60.0):
                    problems.append("drain timed out with requests still "
                                    "in flight")
            else:
                res = _run_smoke_inproc(service, args.smoke,
                                        args.smoke_streams,
                                        seed=cfg.device.seed)
                # read the window BEFORE stop(), same reason
                snap = service.meter.snapshot(time.perf_counter(),
                                              reset=False)
                service.stop()
            export_trace()
            print(serve_log_line(snap))
            print(res.summary(), file=sys.stderr)
            for p in problems:
                print(f"serve: smoke lifecycle violation: {p}",
                      file=sys.stderr)
            events.emit("run_end", smoke_requests=res.completed,
                        smoke_failed=res.failed,
                        compile_count=service.engine.compile_count)
            return 1 if problems else _smoke_rc(res, args.smoke)

        # long-running mode: the worker serves; this thread flushes stats
        # windows until SIGTERM/SIGINT starts the drain
        try:
            while not stop_signal.wait(serve_cfg.stats_interval_s):
                service._emit_stats(force=True)
        finally:
            print(f"serve: {got.get('signal', 'shutdown')} — draining "
                  f"(readyz 503 for {args.drain_grace_s}s, then completing "
                  "in-flight requests)", file=sys.stderr)
            if server is not None:
                server.drain(grace_s=args.drain_grace_s)
            else:
                service.stop()
            export_trace()
            events.emit("run_end", signal=got.get("signal"),
                        compile_count=service.engine.compile_count)
            print("serve: drained — every accepted request resolved",
                  file=sys.stderr)
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
