"""The capture client and trace reader (stdlib only: it runs from any
machine with Python, torch or not):

- ``python -m byol_tpu_torch capture HOST:PORT DURATION_MS --log-dir DIR``
  (``main``; JAX users point ``python -m jax.collect_profile`` at
  ``--profile-port`` for the same): asks a run's capture server
  (observability/profiling.py) for at least DURATION_MS of whole steps,
  writes the gzipped Chrome trace to :func:`profile_path` under DIR,
  prints the captured step range and the top 10 kernels by device time,
  and exits nonzero with the server's message on anything but 200;
- ``profile_path``: JAX's ``plugins/profile/<run>/`` layout with torch's
  ``.pt.trace.json.gz`` suffix (Perfetto and the torch TensorBoard plugin
  read it); ``profiling.trace`` writes there too;
- ``top_kernels(path, n)``: a trace's ``"cat": "kernel"`` events by name.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Tuple

# the server's wait for a step boundary, to start a capture and again to
# stop it, past the duration
START_GRACE_S = 30.0


def profile_path(logdir: str, host: str, rank: int) -> str:
    """``logdir/plugins/profile/<YYYY_MM_DD_HH_MM_SS>/<host>.rank<r>
    .pt.trace.json.gz`` (JAX's run layout, torch's suffix), made
    unique."""
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
    for n in range(1000):
        run = os.path.join(logdir, "plugins", "profile",
                           stamp + (f"_{n}" if n else ""))
        path = os.path.join(run, f"{host}.rank{rank}.pt.trace.json.gz")
        if not os.path.exists(path):
            os.makedirs(run, exist_ok=True)
            return path
    raise FileExistsError(f"{logdir}: 1000 traces of {stamp}")


def load_trace(path: str) -> List[dict]:
    """The ``traceEvents`` of a Chrome trace, gzipped or not."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def top_kernels(trace_path: str, n: Optional[int] = 10) -> List[dict]:
    """The trace's ``"cat": "kernel"`` events by name, most device time
    first: ``{"name", "ms", "calls", "share"}`` (``share`` of all kernel
    time), the first ``n`` (all for None)."""
    ms: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for e in load_trace(trace_path):
        if e.get("cat") == "kernel":
            name = e.get("name", "")
            ms[name] = ms.get(name, 0.0) + float(e.get("dur", 0.0)) / 1e3
            calls[name] = calls.get(name, 0) + 1
    total = sum(ms.values())
    rows = [{"name": k, "ms": v, "calls": calls[k],
             "share": v / total if total else 0.0}
            for k, v in sorted(ms.items(), key=lambda kv: -kv[1])]
    return rows if n is None else rows[:n]


def capture(address: str, duration_ms: int,
            log_dir: str) -> Tuple[str, Dict[str, str]]:
    """Ask the server at ``HOST:PORT`` for ``duration_ms`` of its run and
    write the trace under ``log_dir``.  -> (path, reply headers).  A
    reply other than 200 raises ``RuntimeError`` with the server's
    message."""
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"{address!r}: want HOST:PORT")
    url = (f"http://{host}:{port}/capture?"
           + urllib.parse.urlencode({"duration_ms": duration_ms}))
    # the server's two boundary waits, then the export of a long trace
    timeout_s = 2 * (duration_ms / 1e3 + START_GRACE_S) + 300.0
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as reply:
            headers = dict(reply.headers.items())
            path = profile_path(log_dir, headers.get("X-Capture-Host", host),
                                int(headers.get("X-Capture-Rank", 0)))
            try:
                # a chunk at a time: a long capture is hundreds of MB
                with open(path, "wb") as f:
                    shutil.copyfileobj(reply, f, 1 << 22)
            except BaseException:
                os.remove(path)
                raise
    except urllib.error.HTTPError as e:
        raise RuntimeError(f"{e.code}: {e.read().decode().strip()}") from None
    return path, headers


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m byol_tpu_torch capture",
        description="capture a trace of a live training run started with "
                    "--profile-port (each rank listens on that port plus "
                    "its local rank)")
    p.add_argument("address", help="HOST:PORT of the rank to capture")
    p.add_argument("duration_ms", type=int,
                   help="at least this many ms of whole steps")
    p.add_argument("--log-dir", required=True,
                   help="the trace goes to LOG_DIR/plugins/profile/<time>/")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    try:
        path, h = capture(args.address, args.duration_ms, args.log_dir)
    except (RuntimeError, ValueError, OSError) as e:
        print(f"capture: {args.address}: {e}", file=sys.stderr)
        return 1
    wall = time.perf_counter() - t0
    first, last = h["X-Capture-First-Step"], h["X-Capture-Last-Step"]
    print(f"capture: steps {first}..{last} ({h['X-Capture-Steps']} steps, "
          f"{float(h['X-Capture-Wall-S']):.3f} s) of rank "
          f"{h['X-Capture-Rank']} on {h['X-Capture-Host']}; the profiler's "
          f"start stalled the run {float(h['X-Capture-Start-S']):.3f} s, "
          f"its stop {float(h['X-Capture-Stop-Stall-S']):.3f} s; "
          f"{os.path.getsize(path) / 1e6:.2f} MB "
          f"({int(h['X-Capture-Trace-Bytes']) / 1e6:.2f} MB of JSON, "
          f"exported in {float(h['X-Capture-Export-S']):.3f} s) in "
          f"{wall:.2f} s -> {path}", flush=True)
    if "X-Capture-Note" in h:
        print(f"capture: {h['X-Capture-Note']}", flush=True)
    rows = top_kernels(path, 10)
    if not rows:
        print("capture: no kernel events (the run is on the CPU)",
              flush=True)
    for r in rows:
        print(f"capture: {r['ms']:10.3f} ms {r['calls']:6d} calls "
              f"{r['share']:6.1%}  {r['name'][:100]}", flush=True)
    return 0
