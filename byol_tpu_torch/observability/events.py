"""Append-only, schema-versioned JSONL run log (counterpart of
byol_tpu/observability/events.py, the same schema).

Every training run (``trainer.fit``) and the serving CLI emit one
machine-readable event stream: a run header with the full config and
environment, interval ``step`` records carrying the unpacked health
vector, ``epoch`` records, anomaly / checkpoint / halt events, the goodput
partition and a run-end marker.  The kinds and their required fields are
the JAX package's, so ``scripts/validate_events.py`` and ``python -m
byol_tpu report`` read the port's logs unchanged.  The one difference is
in what a field holds: the port's ``run_header`` writes ``"jax_version":
null`` (the field is required by the schema, and the port runs no JAX)
and adds ``torch_version`` and ``device_name``; additive fields need no
schema bump.

Format: one JSON object per line, STRICT JSON.  The events most worth
machine-reading are the failure records, and those carry non-finite
floats (a NaN loss in an anomaly snapshot): :func:`sanitize` maps them to
the strings ``"NaN"`` / ``"Infinity"`` / ``"-Infinity"`` at emit time, and
the envelope is dumped with ``allow_nan=False``.  Writes are line-buffered
and append-only: a crash loses at most the line being written, and a
resumed run extends its predecessor's log.  Each line stamps ``"v":
SCHEMA_VERSION``; :func:`validate_event` checks the per-kind required
fields and the goodput identity, and :func:`read_events` is the strict
reader.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np

SCHEMA_VERSION = 1

# kind -> required payload fields (beyond the envelope v/kind/t); the JAX
# package's table.  Adding a kind or an OPTIONAL field is compatible;
# changing required fields bumps SCHEMA_VERSION.
EVENT_KINDS: Dict[str, tuple] = {
    "run_header": ("config", "jax_version", "backend"),
    "step": ("step", "health"),
    "epoch": ("epoch", "split", "metrics"),
    "anomaly": ("step", "rule"),
    "checkpoint": ("epoch",),
    "halt": ("step", "reason"),
    "state_dump": ("step",),
    "bench_row": ("config",),
    # the serving meter's window snapshot
    "serve_stats": ("requests", "batches", "p50_ms", "p99_ms"),
    # observability/goodput.py: one ``goodput`` event per epoch window and
    # one run-scope total; ``span_stats`` carries the window's per-name
    # span aggregates.  The partition identity (productive + sum(badput)
    # == wall) is validated below.
    "goodput": ("scope", "wall_seconds", "productive_seconds", "badput"),
    "span_stats": ("scope", "spans"),
    "run_end": (),
}

# run_header.sharding_plan: optional, but when present it must name the
# whole plan
SHARDING_PLAN_FIELDS = ("mesh_shape", "axis_names", "zero1",
                        "donate_argnums")


def sanitize(obj: Any) -> Any:
    """JSON-strict deep copy of a payload: non-finite floats become the
    strings ``"NaN"`` / ``"Infinity"`` / ``"-Infinity"``, tuples and arrays
    become lists.  Every strict-JSON writer of the port (run log, grapher
    lines, span attributes, checkpoint meta.json) goes through it."""
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return sanitize(obj.tolist())
    if isinstance(obj, (float, np.floating)):
        f = float(obj)
        if math.isnan(f):
            return "NaN"
        if math.isinf(f):
            return "Infinity" if f > 0 else "-Infinity"
        return f
    return obj


def _json_default(obj: Any):
    """Serialize numpy scalars and tensors that reach an event payload."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, (np.floating, np.ndarray)):
        return sanitize(obj)
    tolist = getattr(obj, "tolist", None)      # torch.Tensor and friends
    if callable(tolist):
        return sanitize(tolist())
    raise TypeError(
        f"event payload value of type {type(obj).__name__} is not "
        "JSON-serializable")


def validate_event(event: Any) -> Dict[str, Any]:
    """Validate one event object against the schema; returns it.

    Raises ``ValueError`` on: non-dict, missing/mismatched schema version,
    unknown kind, a missing required field for the kind, a malformed
    sharding plan, or a goodput partition that does not sum to wall time
    within 1 %.
    """
    if not isinstance(event, dict):
        raise ValueError(f"event must be a JSON object, got {type(event)}")
    v = event.get("v")
    if v != SCHEMA_VERSION:
        raise ValueError(
            f"event schema version {v!r} != supported {SCHEMA_VERSION}")
    kind = event.get("kind")
    if kind not in EVENT_KINDS:
        raise ValueError(
            f"unknown event kind {kind!r}; known: {sorted(EVENT_KINDS)}")
    missing = [f for f in EVENT_KINDS[kind] if f not in event]
    if missing:
        raise ValueError(
            f"event kind {kind!r} missing required field(s) {missing}")
    if kind == "run_header" and "sharding_plan" in event:
        sp = event["sharding_plan"]
        if not isinstance(sp, dict):
            raise ValueError(
                f"run_header.sharding_plan must be an object, got "
                f"{type(sp).__name__}")
        sp_missing = [f for f in SHARDING_PLAN_FIELDS if f not in sp]
        if sp_missing:
            raise ValueError(
                f"run_header.sharding_plan missing field(s) {sp_missing} "
                f"(expected {list(SHARDING_PLAN_FIELDS)})")
        if sp.get("zero1") not in ("off", "on"):
            raise ValueError(
                f"run_header.sharding_plan.zero1 must be 'off'|'on', got "
                f"{sp.get('zero1')!r}")
    if kind == "goodput":
        bp = event["badput"]
        if not isinstance(bp, dict):
            raise ValueError(
                f"goodput.badput must be an object of bucket seconds, got "
                f"{type(bp).__name__}")
        vals = [event["wall_seconds"], event["productive_seconds"],
                *bp.values()]
        if all(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in vals):
            # the partition must SUM to wall time (1 % covers the reader's
            # float round trip; the writer computes it exactly)
            wall = float(event["wall_seconds"])
            total = (float(event["productive_seconds"])
                     + sum(float(v) for v in bp.values()))
            if abs(total - wall) > max(0.01 * abs(wall), 1e-6):
                raise ValueError(
                    f"goodput buckets sum to {total:.6f}s but wall is "
                    f"{wall:.6f}s (off by more than 1%): the partition "
                    "must be exhaustive (goodput.py fold contract)")
    return event


class RunLog:
    """Line-buffered append-only JSONL event writer.

    ``emit(kind, **payload)`` stamps the envelope (schema version, kind,
    wall time), validates, and writes one line.  ``best_effort=True``
    turns environment failures (OSError: disk full, quota, read-only file
    system), at construction and on every write, into a one-line warning
    that disables the log: observability must never kill the run it
    observes.  Schema violations (ValueError) always raise: those are
    caller bugs.
    """

    def __init__(self, path: Optional[str], *,
                 best_effort: bool = False) -> None:
        """``path`` None: a log that validates every event and writes
        none (a data-parallel rank other than 0)."""
        self.path = path
        self.best_effort = best_effort
        self.disabled = path is None
        self._f = None
        if path is None:
            return
        try:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._f = open(path, "a", buffering=1)
        except OSError as e:
            if not best_effort:
                raise
            self._write_failed(e)

    def _write_failed(self, exc: OSError) -> None:
        self.disabled = True
        print(f"events: {self.path} failed ({exc!r}); run log "
              "disabled for the rest of the run", file=sys.stderr)
        try:
            if self._f is not None:
                self._f.close()
        except OSError:
            pass

    def emit(self, kind: str, **payload: Any) -> Dict[str, Any]:
        event = {"v": SCHEMA_VERSION, "kind": kind, "t": time.time(),
                 **payload}
        validate_event(event)
        if self.disabled:
            return event
        try:
            self._f.write(json.dumps(sanitize(event), default=_json_default,
                                     allow_nan=False) + "\n")
        except OSError as e:
            if not self.best_effort:
                raise
            self._write_failed(e)
        return event

    def flush(self) -> None:
        if not self.disabled:
            self._f.flush()

    def close(self) -> None:
        if not self.disabled and self._f is not None and not self._f.closed:
            self._f.close()

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> Iterator[Dict[str, Any]]:
    """Strict reader: yields every event, validated; raises ``ValueError``
    naming the line number on a corrupt or schema-invalid line."""
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: corrupt JSONL line: {e}") from e
            try:
                yield validate_event(obj)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from e


def run_header_env(device) -> Dict[str, Any]:
    """The port's environment fields of a ``run_header`` for a run on
    ``device``: the schema's required ``jax_version`` (null: no JAX runs
    here) and ``backend``, and the additive ``torch_version`` and
    ``device_name``."""
    import torch
    device = torch.device(device)
    return {"jax_version": None, "torch_version": torch.__version__,
            "backend": device.type,
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")}
