"""WireServer: the HTTP front door over one EmbeddingService.

Counterpart of byol_tpu/serving/net/server.py, over the port's
:class:`~byol_tpu_torch.serving.service.EmbeddingService`, with the same
routes, statuses, drain order and spans.

``ThreadingHTTPServer`` (stdlib, one thread per connection) adapting the
wire protocol to ``EmbeddingService.submit``:

- ``POST /v1/embed`` — one protocol frame in, one frame of float32
  embeddings out.  Every malformed/oversized/wrong-dtype request is THAT
  client's mapped 4xx (protocol.py); a decode error can never kill the
  server or reach the batcher.
- ``GET /healthz`` — liveness: 200 while the process can answer at all.
- ``GET /readyz`` — readiness: 200 while accepting embed traffic, 503
  the moment a drain begins — the signal a load balancer keys eviction
  on, flipped BEFORE accepted requests finish (Kubernetes-style:
  fail readiness first, drain second, exit last).
- ``GET /statsz`` — the live ServingMeter window + engine provenance as
  strict JSON (non-finite floats as strings, the events.py convention).

**Deadline-aware admission control.**  ``X-Deadline-Ms`` (default:
``default_deadline_ms``) is the client's total budget measured from the
first request byte.  It propagates into both wait points — the bounded
queue's submit timeout and the future's result timeout — so an overloaded
service answers 429 (queue still full at deadline, with ``Retry-After``)
or 408 (accepted but not embedded in time) WITHIN the budget, never a
hang.  A request whose budget is already spent at admission is 408 on
the spot: no queue slot is burned staging work nobody will wait for.

**Graceful lifecycle.**  :meth:`begin_drain` flips ``/readyz`` to 503 and
refuses new embeds (503 + Retry-After); :meth:`drain` then waits for
every in-flight request to finish (admission holds a counted slot, so
"in flight" is exact, not a sleep), closes the listener, and stops the
service — which drains everything the batcher accepted.  SIGTERM in the
CLI calls exactly this, so every accepted request completes before exit.

The admission slot is released only after the answer is written AND
counted in the meter (the JAX server releases it before counting), so the
stats window that ``service.stop()`` emits at the end of a drain holds
every admitted request's status.

Threading contract: handler threads touch only ``service.submit`` /
``Request.result`` (thread-safe by the batcher's contract), the meter
(locked), and the recorder (append-only ring).  The server holds no
per-request state outside the handler's stack frame.
"""
from __future__ import annotations

import json
import math
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from byol_tpu_torch.observability.events import sanitize
from byol_tpu_torch.serving.batcher import Backpressure, ServiceClosed
from byol_tpu_torch.serving.net import protocol

# wire lifecycle phases, in causal order — the HTTP-layer analog of
# batcher.LIFECYCLE_PHASES; meter.record_wire folds the deltas into the
# serve_stats ``wire.phase_ms`` breakdown
WIRE_PHASES = ("read", "parse", "wait", "write")


def _retry_after_s(batcher: Any) -> int:
    """Retry-After hint: roughly one flush cadence — long enough that a
    retry lands after the queue moved, short enough to keep tail latency
    bounded for a well-behaved client."""
    wait = getattr(batcher, "max_wait_s", 0.005)
    return max(1, int(round(wait * 10)))


class _Handler(BaseHTTPRequestHandler):
    """One instance per request (stdlib contract); all shared state lives
    on ``self.server.wire`` (the WireServer)."""

    protocol_version = "HTTP/1.1"       # keep-alive: the client reuses
    server_version = "byol-embed/1"     # one connection per stream
    # idle keep-alive hygiene: a connection that sends nothing for this
    # long is closed (socketserver applies it via settimeout, and
    # handle_one_request maps the timeout to close_connection) — an
    # abandoned connection must not hold a handler thread forever
    timeout = 120.0
    # TCP_NODELAY: an answer goes out as two writes (headers, then the
    # body); under Nagle the body waits for the ACK of the headers, which
    # the client delays (40 ms on Linux) on a keep-alive connection —
    # every request would pay it.  The JAX server leaves Nagle on.
    disable_nagle_algorithm = True

    # ---- plumbing ---------------------------------------------------------
    @property
    def wire(self) -> "WireServer":
        return self.server.wire         # type: ignore[attr-defined]

    def log_message(self, fmt: str, *args: Any) -> None:
        if self.wire.verbose:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _send(self, status: int, body: bytes, content_type: str,
              extra: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, status: int, code: str, message: str,
                         request_id: str = "",
                         extra: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps({"error": code, "message": message,
                           "request_id": request_id},
                          allow_nan=False).encode()
        self._send(status, body, "application/json", extra)

    # ---- GET: health / readiness / stats ----------------------------------
    def do_GET(self) -> None:  # noqa: N802 — stdlib handler contract
        if self.path == "/healthz":
            self._send(200, b"ok\n", "text/plain")
        elif self.path == "/readyz":
            if self.wire.draining:
                self._send(503, b"draining\n", "text/plain",
                           {"Retry-After": "1"})
            else:
                self._send(200, b"ready\n", "text/plain")
        elif self.path == "/statsz":
            self._send(200, self.wire.stats_json(), "application/json")
        else:
            self._send_error_json(404, "not_found",
                                  f"no route {self.path!r}")

    # ---- POST /v1/embed ----------------------------------------------------
    def do_POST(self) -> None:  # noqa: N802 — stdlib handler contract
        if self.path != "/v1/embed":
            self._send_error_json(404, "not_found",
                                  f"no route {self.path!r}")
            return
        wire = self.wire
        t0 = time.perf_counter()
        phases: Dict[str, float] = {}
        request_id = (self.headers.get("X-Request-Id")
                      or wire.next_request_id())
        status = 500
        self._holds_slot = False
        try:
            status = self._embed(wire, t0, phases, request_id)
        except (BrokenPipeError, ConnectionResetError):
            status = 499            # client went away mid-answer; nginx's
            self.close_connection = True      # convention for the meter
        except Exception as e:  # noqa: BLE001 — a handler bug must be THIS
            # request's 500, never the server's death (the front-door twin
            # of the worker's per-batch relay)
            wire.log(f"embed handler error ({request_id}): {e!r}")
            try:
                self._send_error_json(500, "internal",
                                      f"unexpected server error: {e!r}",
                                      request_id)
            except OSError:
                self.close_connection = True
        finally:
            # counted, THEN released: the drain stops the service (and
            # emits the last stats window) only after every admitted
            # request's answer is in the meter
            wire.service.meter.record_wire(status, phases)
            if self._holds_slot:
                wire.release()

    def _embed(self, wire: "WireServer", t0: float,
               phases: Dict[str, float], request_id: str) -> int:
        recorder = wire.service.recorder
        # -- deadline: parsed FIRST so every later wait knows its budget
        raw_deadline = self.headers.get("X-Deadline-Ms")
        try:
            deadline_ms = (float(raw_deadline) if raw_deadline is not None
                           else wire.default_deadline_ms)
            # isfinite, not a NaN/+inf pair test: "-Infinity" parses as a
            # float too, and admitting it would read+parse a full body
            # only to answer the 408 this header already guaranteed
            if not math.isfinite(deadline_ms):
                raise ValueError(raw_deadline)
        except (TypeError, ValueError):
            # answered BEFORE the body is read: the unread bytes would
            # desync the next request on this keep-alive connection, so
            # it must close (same contract as the oversized-body 413)
            self._send_error_json(400, "bad_deadline",
                                  f"X-Deadline-Ms {raw_deadline!r} is not "
                                  "a finite number", request_id,
                                  {"Connection": "close"})
            self.close_connection = True
            return 400
        deadline = t0 + deadline_ms / 1e3

        # -- admission: drain state + body size, both BEFORE reading
        if not wire.admit():
            self._send_error_json(
                503, "draining", "the service is draining; retry against "
                "another replica", request_id,
                {"Retry-After": str(_retry_after_s(wire.service.batcher)),
                 "Connection": "close"})
            self.close_connection = True
            return 503
        self._holds_slot = True          # released by do_POST
        return self._admitted(wire, recorder, phases, request_id, t0,
                              deadline)

    def _admitted(self, wire: "WireServer", recorder: Any,
                  phases: Dict[str, float], request_id: str,
                  t0: float, deadline: float) -> int:
        length = self.headers.get("Content-Length")
        if length is None:
            # pre-read answer: close, or the unread (possibly chunked)
            # body desyncs the connection's next request
            self._send_error_json(411, "length_required",
                                  "Content-Length is required (chunked "
                                  "bodies are not part of wire v1)",
                                  request_id, {"Connection": "close"})
            self.close_connection = True
            return 411
        try:
            nbytes = int(length)
        except ValueError:
            self._send_error_json(400, "bad_frame",
                                  f"Content-Length {length!r} is not an "
                                  "integer", request_id,
                                  {"Connection": "close"})
            self.close_connection = True
            return 400
        if nbytes > wire.max_body_bytes:
            # refused BEFORE buffering: the cap is the largest legal
            # payload, so an oversized body cannot cost its size in RAM
            self._send_error_json(
                413, "too_large",
                f"body of {nbytes}B exceeds the service's "
                f"{wire.max_body_bytes}B cap", request_id,
                {"Connection": "close"})
            self.close_connection = True     # the unread body poisons
            return 413                       # the connection

        with recorder.span("http/read", request_id=request_id):
            body = self.rfile.read(nbytes)
        phases["read"] = time.perf_counter() - t0
        if len(body) != nbytes:
            self._send_error_json(400, "bad_frame",
                                  f"body ended at {len(body)}B of the "
                                  f"declared {nbytes}B", request_id,
                                  {"Connection": "close"})
            self.close_connection = True
            return 400

        t_parse = time.perf_counter()
        try:
            with recorder.span("http/parse", request_id=request_id):
                images = protocol.decode_request(
                    body, input_shape=wire.input_shape,
                    max_rows=wire.max_rows)
        except protocol.WireError as e:
            self._send_error_json(e.status, e.code, e.message, request_id)
            return e.status
        phases["parse"] = time.perf_counter() - t_parse

        remaining = deadline - time.perf_counter()
        if remaining <= 0:
            self._send_error_json(408, "deadline_expired",
                                  "the X-Deadline-Ms budget was spent "
                                  "before the request could be queued",
                                  request_id)
            return 408

        t_wait = time.perf_counter()
        try:
            with recorder.span("http/wait", request_id=request_id):
                req = wire.service.submit(images, timeout=remaining,
                                          trace_id=request_id)
                remaining = deadline - time.perf_counter()
                embeddings = req.result(timeout=max(remaining, 0.0))
        except Backpressure as e:
            self._send_error_json(
                429, "backpressure", str(e), request_id,
                {"Retry-After": str(_retry_after_s(wire.service.batcher))})
            return 429
        except ServiceClosed as e:
            self._send_error_json(
                503, "draining", str(e), request_id,
                {"Retry-After": str(_retry_after_s(wire.service.batcher)),
                 "Connection": "close"})
            self.close_connection = True
            return 503
        except TimeoutError:
            # the future stays owned by the worker, which will resolve it
            # (nothing stranded); only this CLIENT stops waiting
            self._send_error_json(408, "deadline_expired",
                                  "accepted but not embedded within the "
                                  "X-Deadline-Ms budget", request_id)
            return 408
        except ValueError as e:
            # the batcher/service's own validation (second line of
            # defense behind protocol.decode_request)
            self._send_error_json(400, "bad_request", str(e), request_id)
            return 400
        except Exception as e:  # noqa: BLE001 — engine failure relayed to
            self._send_error_json(500, "embed_failed",   # THIS request
                                  f"embed failed: {e!r}", request_id)
            return 500
        finally:
            phases["wait"] = time.perf_counter() - t_wait

        t_write = time.perf_counter()
        with recorder.span("http/write", request_id=request_id):
            self._send(200, protocol.encode_response(embeddings),
                       "application/octet-stream",
                       {"X-Request-Id": request_id})
        phases["write"] = time.perf_counter() - t_write
        return 200


class WireServer:
    """The lifecycle wrapper: bind, serve, drain, stop.

    ``port=0`` binds an ephemeral port (tests, bench) — read
    :attr:`address` after :meth:`start` for the bound endpoint.
    """

    def __init__(self, service: Any, host: str = "127.0.0.1",
                 port: int = 0, *, default_deadline_ms: float = 30_000.0,
                 verbose: bool = False) -> None:
        self.service = service
        self.host = host
        self.port = port
        self.default_deadline_ms = float(default_deadline_ms)
        self.verbose = verbose
        self.input_shape = tuple(service.engine.input_shape)
        self.max_rows = int(service.batcher.max_batch)
        self.max_body_bytes = protocol.max_request_bytes(
            self.input_shape, self.max_rows)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._cond = threading.Condition()
        self._inflight = 0
        self._draining = False
        self._request_ids = iter(range(1, 1 << 62))

    # ---- lifecycle --------------------------------------------------------
    def start(self) -> "WireServer":
        if self._httpd is not None:
            raise RuntimeError("server already started")
        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.wire = self          # type: ignore[attr-defined]
        # in-flight requests are tracked by the admission counter, not by
        # joining connection threads — an idle keep-alive connection must
        # not block drain (block_on_close would make server_close() join
        # every handler thread, including ones parked in readline on a
        # connection the client simply never closed)
        self._httpd.daemon_threads = True
        self._httpd.block_on_close = False
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="wire_server", daemon=True)
        self._thread.start()
        return self

    @property
    def address(self) -> Tuple[str, int]:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[:2]

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Flip ``/readyz`` to 503 and refuse new embeds.  Idempotent,
        cheap, and SEPARATE from :meth:`drain` so the CLI can hold the
        503 window open (``--drain-grace-s``) long enough for a load
        balancer's readiness prober to notice before connections close."""
        with self._cond:
            self._draining = True

    def drain(self, grace_s: float = 0.0,
              timeout_s: Optional[float] = None) -> bool:
        """Graceful stop: fail readiness, wait out in-flight requests,
        close the listener, stop the service (which drains the batcher).
        Returns True when every in-flight request finished, False on a
        ``timeout_s`` bailout (the listener still closes — a stuck
        request must not hold the process hostage forever)."""
        self.begin_drain()
        if grace_s > 0:
            time.sleep(grace_s)
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        clean = True
        with self._cond:
            while self._inflight > 0:
                wait = (None if deadline is None
                        else deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    clean = False
                    break
                self._cond.wait(timeout=wait)
        self.close()
        self.service.stop()
        return clean

    def close(self) -> None:
        """Stop the listener WITHOUT draining (tests, error paths)."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None

    # ---- admission accounting (handler threads) ----------------------------
    def admit(self) -> bool:
        with self._cond:
            if self._draining:
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._cond:
            self._inflight -= 1
            if self._inflight == 0:
                self._cond.notify_all()

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    # ---- misc --------------------------------------------------------------
    def next_request_id(self) -> str:
        return f"wire-{next(self._request_ids)}"

    def stats_json(self) -> bytes:
        snap = self.service.meter.snapshot(time.perf_counter(),
                                           reset=False)
        payload = {"serve_stats": sanitize(snap),
                   "draining": self._draining,
                   "inflight": self.inflight}
        describe = getattr(self.service.engine, "describe", None)
        if callable(describe):
            payload["engine"] = sanitize(describe())
        return (json.dumps(payload, allow_nan=False) + "\n").encode()

    def log(self, msg: str) -> None:
        print(f"wire: {msg}", file=sys.stderr)
