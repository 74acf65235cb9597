"""The port's run log and report (byol_tpu_torch/observability/events.py,
report.py) held against the JAX package's.

- The schema is JAX's: the same kinds and required fields, the same
  schema version; every line the port writes passes JAX's
  ``validate_event``, and JAX's lines pass the port's.
- RunLog: round trip, validation at emit, strict JSON for non-finite
  floats and tensors, best effort at construction and on write, lines on
  disk before close; the port's ``run_header`` carries ``jax_version:
  null`` with ``torch_version`` and ``device_name``.
- report: the port's renderer gives JAX's text on the same events, apart
  from the header's version field, and JAX's exit codes (0, 1 for no
  goodput or a broken partition, 2 for an unreadable log);
  ``python -m byol_tpu_torch report`` reaches it.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from byol_tpu.observability import events as jax_events
from byol_tpu.observability import report as jax_report
from byol_tpu_torch.observability import events, report
from byol_tpu_torch.observability.health import HEALTH_FIELDS

ROOT = Path(__file__).resolve().parents[1]


def test_schema_is_jax_schema():
    assert events.SCHEMA_VERSION == jax_events.SCHEMA_VERSION
    assert events.EVENT_KINDS == jax_events.EVENT_KINDS
    assert events.SHARDING_PLAN_FIELDS == jax_events.SHARDING_PLAN_FIELDS


@pytest.mark.parametrize("value", [1.5, float("nan"), float("inf"),
                                   -float("inf"), np.float32("nan"),
                                   np.array([1.0, np.inf]), (1, 2.0),
                                   {"a": [np.nan]}])
def test_sanitize_is_jax_sanitize(value):
    assert events.sanitize(value) == jax_events.sanitize(value)


def test_run_header_of_the_port_passes_both_validators(tmp_path):
    p = str(tmp_path / "run.jsonl")
    with events.RunLog(p) as log:
        log.emit("run_header", config={"a": 1},
                 **events.run_header_env("cpu"))
    (line,) = Path(p).read_text().splitlines()
    obj = json.loads(line)
    assert obj["jax_version"] is None and obj["backend"] == "cpu"
    assert obj["torch_version"] == torch.__version__
    assert obj["device_name"] == "cpu"
    assert jax_events.validate_event(obj) == events.validate_event(obj)


def test_roundtrip_all_kinds_through_both_readers(tmp_path):
    p = str(tmp_path / "run.jsonl")
    with events.RunLog(p) as log:
        log.emit("run_header", config={"a": 1}, jax_version=None,
                 backend="cpu")
        log.emit("step", step=50, health={k: 0.0 for k in HEALTH_FIELDS})
        log.emit("epoch", epoch=0, split="train",
                 metrics={"loss_mean": torch.tensor(1.0)},
                 input_pipeline={"h2d_bytes_per_step": 1.0})
        log.emit("anomaly", step=50, rule="collapse", detail="x")
        log.emit("checkpoint", epoch=0, best_metric=1.0)
        log.emit("halt", step=51, reason="nonfinite")
        log.emit("state_dump", step=51)
        log.emit("goodput", scope="run", wall_seconds=2.0,
                 productive_seconds=1.5, badput={"host_other": 0.5})
        log.emit("span_stats", scope="epoch", spans={})
        log.emit("serve_stats", requests=1, batches=1, p50_ms=1.0,
                 p99_ms=2.0)
        log.emit("run_end", epoch=0)
    ours = list(events.read_events(p))
    theirs = list(jax_events.read_events(p))
    assert ours == theirs
    assert [e["kind"] for e in ours][0] == "run_header"
    assert ours[2]["metrics"]["loss_mean"] == 1.0     # tensor serialized


def test_emit_validates_kind_fields_and_goodput_identity(tmp_path):
    log = events.RunLog(str(tmp_path / "r.jsonl"))
    with pytest.raises(ValueError, match="unknown event kind"):
        log.emit("not_a_kind", x=1)
    with pytest.raises(ValueError, match="missing required"):
        log.emit("epoch", epoch=0, split="train")
    with pytest.raises(ValueError, match="sum"):
        log.emit("goodput", scope="run", wall_seconds=10.0,
                 productive_seconds=5.0, badput={"input_wait": 1.0})
    with pytest.raises(ValueError, match="sharding_plan"):
        log.emit("run_header", config={}, jax_version=None, backend="cpu",
                 sharding_plan={"zero1": "on"})
    log.close()


def test_nonfinite_floats_emit_strict_json(tmp_path):
    p = str(tmp_path / "r.jsonl")
    vals = {k: 0.0 for k in HEALTH_FIELDS}
    vals.update(loss=float("nan"), grad_norm=float("inf"),
                trust_min=np.float32("-inf"))
    with events.RunLog(p) as log:
        log.emit("step", step=50, health=vals,
                 extra=torch.tensor([1.0, float("nan")]))
    (line,) = Path(p).read_text().splitlines()
    e = json.loads(line, parse_constant=lambda tok: pytest.fail(
        f"bare {tok} token: not strict JSON"))
    assert e["health"]["loss"] == "NaN"
    assert e["health"]["grad_norm"] == "Infinity"
    assert e["health"]["trust_min"] == "-Infinity"
    assert e["extra"] == [1.0, "NaN"]


def test_best_effort_disables_instead_of_raising(tmp_path, capsys):
    class _FullDisk:
        closed = False

        def write(self, s):
            raise OSError(28, "No space left on device")

        def close(self):
            pass

    p = str(tmp_path / "r.jsonl")
    log = events.RunLog(p, best_effort=True)
    log.emit("run_end")
    log._f.close()
    log._f = _FullDisk()
    log.emit("run_end", epoch=1)                     # must not raise
    assert log.disabled
    log.emit("run_end", epoch=2)
    log.flush()
    log.close()
    assert [e["kind"] for e in events.read_events(p)] == ["run_end"]
    with pytest.raises(ValueError):
        log.emit("not_a_kind")
    blocker = tmp_path / "blocker"
    blocker.write_text("not a dir")
    with pytest.raises(OSError):
        events.RunLog(str(blocker / "run.jsonl"))
    off = events.RunLog(str(blocker / "run.jsonl"), best_effort=True)
    assert off.disabled
    off.emit("run_end")
    off.close()
    assert "disabled" in capsys.readouterr().err


def test_lines_are_on_disk_before_close(tmp_path):
    p = str(tmp_path / "r.jsonl")
    log = events.RunLog(p)
    log.emit("run_end")
    assert [e["kind"] for e in events.read_events(p)] == ["run_end"]
    log.close()


def test_reader_rejects_corrupt_and_drifted_lines(tmp_path):
    p = tmp_path / "r.jsonl"
    with events.RunLog(str(p)) as log:
        log.emit("run_end")
    with open(p, "a") as f:
        f.write("{not json\n")
    with pytest.raises(ValueError, match=":2:"):
        list(events.read_events(str(p)))
    p2 = tmp_path / "r2.jsonl"
    p2.write_text(json.dumps({"v": 999, "kind": "run_end", "t": 0.0}) + "\n")
    with pytest.raises(ValueError, match="schema version"):
        list(events.read_events(str(p2)))


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _sample_events(version_field):
    return [
        ("run_header", {"config": {}, "jax_version": None, "backend": "cuda",
                        "run_name": "r", **version_field}),
        ("epoch", {"epoch": 0, "split": "train", "metrics": {},
                   "step_time_p50_s": 0.1, "step_time_p99_s": 0.3}),
        ("goodput", {"scope": "epoch", "epoch": 0, "wall_seconds": 10.0,
                     "productive_seconds": 8.0,
                     "badput": {"input_wait": 1.5, "host_other": 0.5}}),
        ("goodput", {"scope": "run", "wall_seconds": 10.0,
                     "productive_seconds": 8.0, "mfu": 0.05,
                     "badput": {"input_wait": 1.5, "host_other": 0.5}}),
        ("serve_stats", {"requests": 4, "batches": 2, "p50_ms": 3.0,
                         "p99_ms": 9.0,
                         "phase_ms": {"coalesce": 1.0, "stage": 0.5,
                                      "dispatch": 1.0, "readback": 0.4,
                                      "deliver": 0.1}}),
        ("anomaly", {"step": 17, "rule": "collapse",
                     "detail": "feature_std low"}),
        ("halt", {"step": 18, "reason": "nonfinite"}),
        ("run_end", {}),
    ]


def _write(tmp_path, evs):
    path = str(tmp_path / "run.jsonl")
    with events.RunLog(path) as log:
        for kind, payload in evs:
            log.emit(kind, **payload)
    return path


def _parsed(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_report_text_is_jax_text_but_the_version(tmp_path):
    path = _write(tmp_path, _sample_events({"torch_version": "2.x"}))
    evs = _parsed(path)
    got, rc = report.render(evs, source=path)
    want, jrc = jax_report.render(evs, source=path)
    assert rc == jrc == 0
    assert got.replace("torch=2.x", "jax=None") == want
    assert "torch=2.x" in got
    for section in ("Goodput waterfall", "mfu 5.0%", "Step-time trend",
                    "Serving latency breakdown", "Anomaly timeline",
                    "collapse", "nonfinite"):
        assert section in got


def test_report_exit_codes_are_jax_codes(tmp_path, capsys):
    nogood = _write(tmp_path, [("run_header", {"config": {},
                                               "jax_version": None,
                                               "backend": "cpu"}),
                               ("run_end", {})])
    assert report.main([nogood]) == jax_report.main([nogood]) == 1
    broken = tmp_path / "broken.jsonl"
    broken.write_text(json.dumps({
        "v": 1, "kind": "goodput", "t": 0.0, "scope": "run",
        "wall_seconds": 100.0, "productive_seconds": 10.0,
        "badput": {"input_wait": 1.0}}) + "\n")
    assert report.main([str(broken)]) == 1
    assert "partition off by" in capsys.readouterr().out
    corrupt = tmp_path / "bad.jsonl"
    corrupt.write_text("{not json\n")
    assert report.main([str(corrupt)]) == 2
    assert report.main([]) == 2


def test_report_subcommand_of_the_package(tmp_path):
    path = _write(tmp_path, _sample_events({"torch_version": "2.x"}))
    proc = subprocess.run(
        [sys.executable, "-m", "byol_tpu_torch", "report", path],
        capture_output=True, text=True, timeout=180, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert "Goodput waterfall" in proc.stdout and "torch=2.x" in proc.stdout
