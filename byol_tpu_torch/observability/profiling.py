"""Profiling on torch.profiler (counterpart of
byol_tpu/observability/profiling.py):

- ``trace(logdir)``: capture a host (+ CUDA, when a card is present) trace
  of the enclosed code into ``logdir`` in the layout the capture client
  writes (:func:`profile_path`; open it in https://ui.perfetto.dev or the
  torch TensorBoard plugin);
- ``annotate(name)``: a named host region (``record_function``) that shows
  up in a captured trace beside the card's kernels;
- ``start_server(port)``: on-demand capture of a live run from another
  shell or machine (``jax.profiler.start_server``'s role), over HTTP:
  ``GET /capture?duration_ms=D`` answers a gzipped Chrome trace of the
  run's next whole steps, at least D ms of them and at most
  :data:`MAX_STEPS`;
- ``step_boundary(step)``: the training thread's side of the server;
  the trainer calls it before every step and between eval batches, and
  ``end_capture`` when the steps end.

The client, ``python -m byol_tpu_torch capture HOST:PORT DURATION_MS
--log-dir DIR`` (``python -m jax.collect_profile``'s role), and
``top_kernels(path, n)``, the kernels of such a trace by device time,
live in observability/capture.py (stdlib only).

torch.profiler records the host work of the thread that starts it only,
and Kineto allows one profiler in a process at a time.  So the listener
thread never profiles: it posts the request, the training thread starts
and stops the profiler at step boundaries, and the listener exports,
compresses and answers.  An idle server costs a step one attribute read.
"""
from __future__ import annotations

import contextlib
import gzip
import http.server
import os
import re
import shutil
import socket
import tempfile
import threading
import time
import urllib.parse
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import torch

from byol_tpu_torch.observability.capture import START_GRACE_S, profile_path

MAX_DURATION_MS = 60_000
# a capture stops at this many steps whatever its duration: Kineto holds
# the events in host memory until the stop, and the export writes them as
# JSON, about 9.5 MB a step of ResNet-50 at batch 64 (PERF.md, PR 15)
MAX_STEPS = 20
_KERNEL = re.compile(rb'"cat"\s{0,8}:\s{0,8}"kernel"')
_CHUNK = 1 << 22                 # the export's reads and the reply's writes

_lock = threading.Lock()
_server: Optional["ProfileServer"] = None
# the one capture slot: the listener posts a request into it, and it is
# free again once the listener has answered and the training thread is
# through with the profiler; step_boundary's one read when it is None
_request: Optional["_Capture"] = None


class _Capture:
    """One request, from its post to its answer."""

    def __init__(self, duration_ms: int, cuda: bool) -> None:
        self.duration_s = duration_ms / 1e3
        self.cuda = cuda
        self.state = "pending"            # -> running -> done
        self.started = threading.Event()  # running, or done without it
        self.done = threading.Event()
        self.answered = False             # the listener has replied
        self.prof: Optional[torch.profiler.profile] = None
        self.t0 = 0.0
        self.first_step = self.seen_step = -1
        self.steps = 0
        self.start_s = self.stall_s = self.wall_s = 0.0
        self.note = ""
        self.error: Optional[Tuple[int, str]] = None


def _other_profiler_active() -> bool:
    """Any torch.profiler session of this process, on any thread (torch
    keeps this flag process-wide; its thread-local state is not)."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


def _finish(req: _Capture, error: Optional[Tuple[int, str]] = None) -> None:
    """``req`` is done, answered with ``error`` if set (hold ``_lock``)."""
    req.state, req.error = "done", error
    if error is not None:
        req.prof = None
    req.started.set()
    req.done.set()
    _release(req)


def _release(req: _Capture) -> None:
    """Free the slot once both sides are through with ``req`` (hold
    ``_lock``)."""
    global _request
    if _request is req and req.answered and req.state == "done":
        _request = None
        req.prof = None


def step_boundary(step: int,
                  pet: Optional[Callable[[], None]] = None) -> bool:
    """The training thread before a step (``step``: the optimizer steps
    done so far).  Starts a pending capture, or stops a running one whose
    duration or step cap has passed; ``pet`` (the watchdog's) is called
    before and after either, so the stall never counts against its
    deadline.  True when it started or stopped one."""
    req = _request
    if req is None or req.state == "done":
        return False
    if req.state == "running":
        req.seen_step = step
        capped = step - req.first_step >= MAX_STEPS
        if (time.perf_counter() - req.t0 < req.duration_s and not capped
                and not req.answered):
            return False
        if pet is not None:
            pet()
        _stop(req, f"stopped at the {MAX_STEPS}-step cap"
              if capped and not req.answered else "")
    else:
        if pet is not None:
            pet()
        _start(req, step)
    if pet is not None:
        pet()
    return True


def _start(req: _Capture, step: int) -> None:
    """Under the lock, so the listener cannot answer the request while
    the profiler starts; a synchronise first, so no earlier step's
    kernels reach the trace."""
    with _lock:
        if req.state != "pending":
            return
        if _other_profiler_active():
            _finish(req, (409, "another torch.profiler is active in this "
                          "process (Kineto allows one at a time); retry "
                          "when it has stopped"))
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if req.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        t = time.perf_counter()
        try:
            if req.cuda:
                torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except Exception as e:           # noqa: BLE001 (answered)
            # the profiler's fault, not the run's: answered, and training
            # goes on
            _finish(req, (500, f"torch.profiler did not start: {e}"))
            return
        req.prof, req.first_step = prof, step
        req.seen_step = step
        req.t0 = time.perf_counter()
        req.start_s = req.t0 - t
        req.state = "running"
        req.started.set()


def _stop(req: _Capture, note: str = "") -> None:
    """Synchronise (every captured step's kernels reach the trace), stop
    the profiler and hand the result to the listener.  Never raises: a
    fault here (a CUDA error the run met) is the reply's 500, and the
    run's own exception goes on."""
    t = time.perf_counter()
    errors = []
    if req.cuda:
        try:
            torch.cuda.synchronize()
        except Exception as e:           # noqa: BLE001 (answered)
            errors.append(f"torch.cuda.synchronize() raised: {e}")
    try:
        req.prof.stop()
    except Exception as e:               # noqa: BLE001 (answered)
        errors.append(f"torch.profiler did not stop: {e}")
    req.stall_s = time.perf_counter() - t
    req.wall_s = t - req.t0
    req.steps = max(req.seen_step - req.first_step, 0)
    req.note = note
    error = None
    if errors:
        error = (500, "; ".join(errors) + (f" ({note})" if note else ""))
    with _lock:
        _finish(req, error)


def end_capture(reason: str = "the run ended",
                error: Optional[BaseException] = None) -> None:
    """Answer the request still open when the steps end (the training
    thread; ``error``: the exception ending them): a running capture
    stops here and its reply says why, a pending one is answered 504.
    Never raises."""
    req = _request
    if req is None:
        return
    if error is not None:
        reason = f"{reason} with {type(error).__name__}: {error}"
    if req.state == "running":
        _stop(req, f"{reason} while capturing")
        return
    with _lock:
        if req.state == "pending":
            _finish(req, (504, f"{reason} before a step boundary served "
                          "the capture"))


# a reply: (status, headers, body), the body as bytes or as the path of a
# file that the handler streams and then removes with its folder
Reply = Tuple[int, Dict[str, str], Union[bytes, str]]


class ProfileServer:
    """The listener: a daemon ``ThreadingHTTPServer`` on all interfaces.
    ``port`` is the bound one (an ephemeral one for ``port=0``)."""

    def __init__(self, port: int, *, cuda: bool, rank: int) -> None:
        self.cuda, self.rank = cuda, rank
        self.host = socket.gethostname()
        self.httpd = http.server.ThreadingHTTPServer(("", port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.owner = self
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="profile-server", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Close the listener; a capture still open is ended (call it from
        the training thread)."""
        global _server
        end_capture("the server stopped")
        self.httpd.shutdown()
        self.httpd.server_close()
        with _lock:
            if _server is self:
                _server = None

    def capture(self, duration_ms: int) -> Reply:
        """Post one request, wait for the training thread to serve it,
        then export and compress here."""
        global _request
        with _lock:
            if _request is not None:
                return _text(409, "a capture is pending or running (or "
                             "being exported) on this process; one at a "
                             "time")
            if _other_profiler_active():
                return _text(409, "another torch.profiler is active in this "
                             "process (Kineto allows one at a time); retry "
                             "when it has stopped")
            req = _request = _Capture(duration_ms, self.cuda)
        try:
            return self._wait_and_reply(req)
        finally:
            with _lock:
                req.answered = True
                _release(req)

    def _wait_and_reply(self, req: _Capture) -> Reply:
        grace = req.duration_s + START_GRACE_S
        if not req.started.wait(grace):
            with _lock:
                if req.state == "pending":
                    _finish(req, (504, f"no step boundary came within "
                                  f"{grace:.0f} s: the run is not stepping "
                                  "(a long eval or checkpoint, or it has "
                                  "finished)"))
        if not req.done.wait(grace):
            return _text(504, f"the capture started at step "
                         f"{req.first_step}, but no step boundary came "
                         f"within {grace:.0f} s to stop it; it stops at the "
                         "run's next one and is discarded")
        if req.error is not None:
            return _text(*req.error)
        prof, req.prof = req.prof, None
        t = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="byol_capture_")
        try:
            raw = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(raw)
            del prof
            raw_bytes = os.path.getsize(raw)
            body = raw + ".gz"
            kernels = _compress(raw, body)
            os.remove(raw)
        except OSError as e:
            shutil.rmtree(tmp, ignore_errors=True)
            return _text(500, f"the trace's export failed: {e}")
        export_s = time.perf_counter() - t
        if req.cuda and req.steps > 0 and not kernels:
            shutil.rmtree(tmp, ignore_errors=True)
            return _text(500, f"the trace of steps {req.first_step}.."
                         f"{req.first_step + req.steps - 1} holds no kernel "
                         "event: CUPTI did not attach to the card")
        headers = {
            "Content-Type": "application/gzip",
            "X-Capture-First-Step": str(req.first_step),
            "X-Capture-Last-Step": str(req.first_step + req.steps - 1),
            "X-Capture-Steps": str(req.steps),
            "X-Capture-Rank": str(self.rank),
            "X-Capture-Host": self.host,
            "X-Capture-Wall-S": f"{req.wall_s:.6f}",
            "X-Capture-Start-S": f"{req.start_s:.6f}",
            "X-Capture-Stop-Stall-S": f"{req.stall_s:.6f}",
            "X-Capture-Export-S": f"{export_s:.6f}",
            "X-Capture-Kernel-Events": str(kernels),
            "X-Capture-Trace-Bytes": str(raw_bytes),
        }
        if req.note:
            headers["X-Capture-Note"] = req.note
        return 200, headers, body


def _compress(src: str, dst: str) -> int:
    """gzip ``src`` into ``dst`` a chunk at a time (neither is held in
    memory whole); -> the ``"cat": "kernel"`` events counted on the way."""
    kernels, tail = 0, b""
    with open(src, "rb") as fin, \
            gzip.open(dst, "wb", compresslevel=1) as fout:
        while True:
            chunk = fin.read(_CHUNK)
            if not chunk:
                return kernels
            fout.write(chunk)
            # a match that ends in the carried tail was counted last time
            data = tail + chunk
            kernels += sum(1 for m in _KERNEL.finditer(data)
                           if m.end() > len(tail))
            tail = data[-64:]


def _text(status: int, message: str) -> Reply:
    return status, {"Content-Type": "text/plain; charset=utf-8"}, \
        (message + "\n").encode()


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "byol_tpu_torch-profile/1"

    def do_GET(self) -> None:  # noqa: N802 (the stdlib's name)
        url = urllib.parse.urlsplit(self.path)
        if url.path != "/capture":
            reply = _text(404, f"no such path {url.path!r}; "
                          "GET /capture?duration_ms=D")
        else:
            reply = self._capture(urllib.parse.parse_qs(url.query))
        status, headers, body = reply
        try:
            self.send_response(status)
            for key, value in headers.items():
                self.send_header(key, value)
            self.send_header("Content-Length", str(
                len(body) if isinstance(body, bytes)
                else os.path.getsize(body)))
            self.end_headers()
            if isinstance(body, bytes):
                self.wfile.write(body)
            else:
                with open(body, "rb") as f:
                    shutil.copyfileobj(f, self.wfile, _CHUNK)
        finally:
            if not isinstance(body, bytes):
                shutil.rmtree(os.path.dirname(body), ignore_errors=True)

    def _capture(self, query) -> Reply:
        raw = query.get("duration_ms", [""])[0]
        try:
            duration_ms = int(raw)
        except ValueError:
            duration_ms = 0
        if not 1 <= duration_ms <= MAX_DURATION_MS:
            return _text(400, f"duration_ms={raw!r}: want an integer from 1 "
                         f"to {MAX_DURATION_MS} (a capture also stops at "
                         f"{MAX_STEPS} steps)")
        return self.server.owner.capture(duration_ms)

    def log_message(self, format, *args) -> None:  # noqa: A002
        pass                                    # the replies say it all


def start_server(port: int = 9999, *,
                 cuda: Optional[bool] = None) -> ProfileServer:
    """Expose this process to on-demand capture on ``port`` (0: an
    ephemeral one, read back as ``.port``).  ``cuda``: trace the card's
    kernels too (default: when one is visible).  The process's global
    rank names its traces.  One server a process, as in JAX."""
    global _server
    with _lock:
        if _server is not None:
            raise ValueError("Only one profiler server can be active at a "
                             f"time (one listens on port {_server.port})")
        _server = ProfileServer(
            port, cuda=torch.cuda.is_available() if cuda is None else cuda,
            rank=_rank())
        return _server


def _rank() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return int(os.environ.get("RANK", "0"))


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a host (+ CUDA, when a card is present) trace of the
    enclosed code into :func:`profile_path` under ``logdir``."""
    if _other_profiler_active():
        raise RuntimeError("another torch.profiler is active in this "
                           "process (Kineto allows one at a time)")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            profile_path(logdir, socket.gethostname(), _rank()))


def annotate(name: str):
    """Named region in the profiler timeline."""
    return torch.profiler.record_function(name)
