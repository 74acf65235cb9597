"""``python -m byol_tpu_torch report <run.jsonl>``: offline run analysis
(counterpart of byol_tpu/observability/report.py, the same renderer).

Renders, from the schema-versioned event log ALONE (no live process, no
card):

1. the **goodput waterfall**: wall time partitioned into productive step
   time and the named badput buckets (run scope, then per epoch), with the
   partition identity checked again (productive + sum(badput) == wall to
   1 %);
2. the **step-time trend**: per-epoch p50/p99 step intervals (the optional
   epoch-event fields of meters.StepTimer);
3. the **serving latency breakdown**: the ``serve_stats`` windows'
   latency tail and per-request phase means;
4. the **anomaly timeline**: every ``anomaly`` / ``halt`` event.

The header line names the torch version where the JAX package's names
``jax=``; the rest of the text is the JAX renderer's, line for line.

Exit status: 0 when the log parses and every goodput partition checks out;
1 when the log has no goodput events (run with ``--spans on``, the
default) or a partition fails the 1 % identity; 2 on usage or an
unreadable file.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Tuple

_BAR_WIDTH = 40


def _fmt_s(seconds: Any) -> str:
    try:
        return f"{float(seconds):9.2f}s"
    except (TypeError, ValueError):
        return f"{seconds!r:>10}"


def _bar(fraction: float, width: int = _BAR_WIDTH) -> str:
    n = max(0, min(width, int(round(fraction * width))))
    return "#" * n


def _num(v: Any) -> Optional[float]:
    """Payload float — events.py maps non-finite floats to strings, which
    render but never aggregate."""
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


def _check_partition(ev: Dict[str, Any]) -> Optional[float]:
    """Relative partition error of one goodput event (None: non-numeric)."""
    wall = _num(ev.get("wall_seconds"))
    productive = _num(ev.get("productive_seconds"))
    badput = ev.get("badput") or {}
    vals = [_num(v) for v in badput.values()]
    if wall is None or productive is None or any(v is None for v in vals):
        return None
    total = productive + sum(vals)
    return abs(total - wall) / max(abs(wall), 1e-9)


def _render_waterfall(out: List[str], ev: Dict[str, Any],
                      label: str) -> bool:
    """Append one waterfall block; returns False when the partition fails
    the 1% identity."""
    wall = _num(ev.get("wall_seconds")) or 0.0
    productive = _num(ev.get("productive_seconds")) or 0.0
    badput: Dict[str, Any] = ev.get("badput") or {}
    err = _check_partition(ev)
    ok = err is None or err <= 0.01
    frac = productive / wall if wall > 0 else 0.0
    out.append(f"-- {label}: wall {_fmt_s(wall).strip()}, "
               f"goodput {frac:6.1%}"
               + (f", mfu {ev['mfu']:.1%}" if _num(ev.get("mfu")) else "")
               + ("" if ok else
                  f"   !! partition off by {err:.1%} (> 1%)"))
    rows = [("productive", productive)]
    rows += sorted(((k, _num(v) or 0.0) for k, v in badput.items()),
                   key=lambda kv: -kv[1])
    for name, secs in rows:
        share = secs / wall if wall > 0 else 0.0
        if name != "productive" and secs == 0.0:
            continue
        out.append(f"   {name:<20} {_fmt_s(secs)} {share:7.1%}  "
                   f"{_bar(share)}")
    if _num(ev.get("spans_dropped")):
        out.append(f"   (flight recorder dropped "
                   f"{int(ev['spans_dropped'])} spans — host_other "
                   "over-reads by their total)")
    return ok


def render(events: List[Dict[str, Any]], *,
           source: str = "") -> Tuple[str, int]:
    """The full report text + exit status for a parsed event list."""
    out: List[str] = []
    rc = 0
    header = next((e for e in events if e["kind"] == "run_header"), None)
    if header is not None:
        out.append(f"run: {header.get('run_name', '(unnamed)')}  "
                   f"backend={header.get('backend')}  "
                   f"torch={header.get('torch_version')}")

    goodputs = [e for e in events if e["kind"] == "goodput"]
    out.append("")
    out.append("== Goodput waterfall ==")
    if not goodputs:
        out.append("   no goodput events in this log — the run recorded "
                   "no spans (re-run with --spans on, the default)")
        rc = 1
    else:
        run_ev = next((e for e in goodputs if e.get("scope") == "run"),
                      goodputs[-1])
        if not _render_waterfall(out, run_ev, "run total"):
            rc = 1
        epoch_evs = [e for e in goodputs if e.get("scope") == "epoch"]
        if epoch_evs:
            out.append("")
            out.append("   epoch   wall      goodput  worst badput bucket")
            for ev in epoch_evs:
                err = _check_partition(ev)
                broken = err is not None and err > 0.01
                if broken:
                    rc = 1
                wall = _num(ev.get("wall_seconds")) or 0.0
                prod = _num(ev.get("productive_seconds")) or 0.0
                badput = {k: _num(v) or 0.0
                          for k, v in (ev.get("badput") or {}).items()}
                worst = max(badput.items(), key=lambda kv: kv[1],
                            default=("-", 0.0))
                frac = prod / wall if wall > 0 else 0.0
                out.append(f"   {ev.get('epoch', '?'):>5}  "
                           f"{_fmt_s(wall)} {frac:8.1%}  "
                           f"{worst[0]} ({worst[1]:.2f}s)"
                           + (f"   !! partition off by {err:.1%} (> 1%)"
                              if broken else ""))

    epochs = [e for e in events if e["kind"] == "epoch"
              and e.get("split") == "train"]
    trend = [(e.get("epoch"), _num(e.get("step_time_p50_s")),
              _num(e.get("step_time_p99_s"))) for e in epochs]
    trend = [t for t in trend if t[1] is not None and t[2] is not None]
    if trend:
        out.append("")
        out.append("== Step-time trend (dispatch intervals) ==")
        out.append("   epoch    p50        p99        p99/p50")
        for ep, p50, p99 in trend:
            out.append(f"   {ep:>5}  {p50 * 1e3:8.2f}ms {p99 * 1e3:8.2f}ms"
                       f"  {p99 / max(p50, 1e-12):7.2f}x")

    serves = [e for e in events if e["kind"] == "serve_stats"]
    lat = [(e, _num(e.get("p50_ms")), _num(e.get("p99_ms")))
           for e in serves]
    lat = [t for t in lat if t[1] is not None and t[2] is not None]
    if lat:
        out.append("")
        out.append("== Serving latency breakdown ==")
        reqs = sum(_num(e.get("requests")) or 0.0 for e, _, _ in lat)
        out.append(f"   {len(lat)} window(s), {int(reqs)} request(s); "
                   f"p50 {min(p for _, p, _ in lat):.2f}-"
                   f"{max(p for _, p, _ in lat):.2f}ms, "
                   f"p99 {min(p for _, _, p in lat):.2f}-"
                   f"{max(p for _, _, p in lat):.2f}ms")
        # lifecycle phase means, request-weighted across windows
        phase_tot: Dict[str, float] = {}
        phase_w = 0.0
        for e, _, _ in lat:
            pm = e.get("phase_ms") or {}
            w = _num(e.get("requests")) or 0.0
            if not pm or w <= 0:
                continue
            phase_w += w
            for k, v in pm.items():
                fv = _num(v)
                if fv is not None:
                    phase_tot[k] = phase_tot.get(k, 0.0) + fv * w
        if phase_w > 0:
            total_ms = sum(phase_tot.values()) / phase_w
            for k, v in phase_tot.items():
                mean = v / phase_w
                share = mean / total_ms if total_ms > 0 else 0.0
                out.append(f"   {k:<20} {mean:8.2f}ms {share:7.1%}  "
                           f"{_bar(share)}")
        # wire-layer block (serving/net): HTTP status histogram +
        # request-weighted read/parse/wait/write means across windows
        status_tot: Dict[str, float] = {}
        wire_tot: Dict[str, float] = {}
        wire_w = 0.0
        for e in serves:
            wire = e.get("wire") or {}
            w = _num(wire.get("http_requests")) or 0.0
            if w <= 0:
                continue
            wire_w += w
            for k, v in (wire.get("status") or {}).items():
                fv = _num(v)
                if fv is not None:
                    status_tot[k] = status_tot.get(k, 0.0) + fv
            for k, v in (wire.get("phase_ms") or {}).items():
                fv = _num(v)
                if fv is not None:
                    wire_tot[k] = wire_tot.get(k, 0.0) + fv * w
        if wire_w > 0:
            hist = "  ".join(f"{k}:{int(v)}"
                             for k, v in sorted(status_tot.items()))
            out.append(f"   wire: {int(wire_w)} HTTP answer(s)  [{hist}]")
            total_ms = sum(wire_tot.values()) / wire_w
            for k, v in sorted(wire_tot.items()):
                mean = v / wire_w
                share = mean / total_ms if total_ms > 0 else 0.0
                out.append(f"   wire/{k:<15} {mean:8.2f}ms {share:7.1%}  "
                           f"{_bar(share)}")

    anomalies = [e for e in events if e["kind"] in ("anomaly", "halt")]
    out.append("")
    out.append("== Anomaly timeline ==")
    if not anomalies:
        out.append("   none")
    else:
        for e in anomalies:
            rule = e.get("rule", e.get("reason", "?"))
            out.append(f"   step {e.get('step', '?'):>8}  "
                       f"{e['kind']:<8} {rule}  "
                       f"{str(e.get('detail', ''))[:80]}")
    if source:
        out.insert(0, f"goodput report — {source}")
    return "\n".join(out) + "\n", rc


def _read_for_report(path: str) -> List[Dict[str, Any]]:
    """Strict read, EXCEPT that a goodput event failing only its partition
    identity is kept: the violated waterfall is exactly what this command
    exists to show (rc 1 with the '!! partition off' diagnostic), and the
    strict reader raising would misreport it as an unreadable file (rc 2).
    Anything else invalid — corrupt JSON, schema drift — still raises."""
    import json

    from byol_tpu_torch.observability.events import (EVENT_KINDS, SCHEMA_VERSION,
                                               validate_event)
    events: List[Dict[str, Any]] = []
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
                validate_event(obj)
            except ValueError as e:
                # structurally complete goodput event => the only possible
                # failure left is the partition identity: keep it for the
                # renderer's diagnostic instead of dying here
                if not (isinstance(obj, dict)
                        and obj.get("kind") == "goodput"
                        and obj.get("v") == SCHEMA_VERSION
                        and all(k in obj
                                for k in EVENT_KINDS["goodput"])
                        and isinstance(obj.get("badput"), dict)):
                    raise ValueError(f"{path}:{lineno}: {e}") from e
            events.append(obj)
    return events


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__, file=sys.stderr)
        return 2
    path = argv[0]
    try:
        events = _read_for_report(path)
    except (OSError, ValueError) as e:
        print(f"report: cannot read {path}: {e}", file=sys.stderr)
        return 2
    text, rc = render(events, source=path)
    print(text, end="")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
