"""The port's on-demand capture server (``--profile-port``;
observability/profiling.py), the counterpart of ``jax.profiler.start_server``
with ``python -m jax.collect_profile`` as its client.

torch.profiler records the host work of the thread that starts it only,
so the training thread starts and stops the capture at step boundaries and
the listener only posts the request.  The live test is that rule's
regression test: a capture posted from a side thread during a tiny fit on
the main thread (ResNet-18, 16 px, fake data, batch 8, 8 steps, spans on,
one torch thread) holds the main thread's ``train/dispatch`` regions and
its ``aten::`` ops.  Then every error answer (400, 404, 409, 500, 504),
the server's rules, the CLI's per-rank port, the client as a subprocess
and ``top_kernels`` on a synthetic kineto trace.
"""
import dataclasses
import glob
import gzip
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from byol_tpu_torch import cli as torch_cli
from byol_tpu_torch.core.config import (Config, DeviceConfig, ModelConfig,
                                        OptimConfig, TaskConfig)
from byol_tpu_torch.data.loader import get_loader
from byol_tpu_torch.observability import capture, profiling
from byol_tpu_torch.training.trainer import fit

ROOT = Path(__file__).resolve().parents[1]
STEPS = 8


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def server():
    """A CPU server on an ephemeral port, stopped after the test."""
    srv = profiling.start_server(0, cuda=False)
    try:
        yield srv
    finally:
        srv.stop()


def _get(port, query="duration_ms=200", path="/capture"):
    """(status, body) of one GET."""
    url = f"http://127.0.0.1:{port}{path}" + (f"?{query}" if query else "")
    try:
        with urllib.request.urlopen(url, timeout=120) as reply:
            return reply.status, reply.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _in_thread(fn, *args):
    """Run ``fn`` on a side thread; -> (thread, result dict)."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except Exception as e:           # noqa: BLE001 (handed back)
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _wait_pending():
    deadline = time.monotonic() + 30
    while profiling._request is None:
        assert time.monotonic() < deadline, "the request was never posted"
        time.sleep(0.005)


def _cfg(root):
    root = Path(root)
    return Config(
        task=TaskConfig(task="fake", batch_size=8, epochs=1,
                        image_size_override=16, augment_placement="step",
                        fused_augment="on", grapher="jsonl",
                        log_dir=str(root / "logs")),
        model=ModelConfig(arch="resnet18", head_latent_size=32,
                          projection_size=16, model_dir=str(root / "models")),
        optim=OptimConfig(lr=0.05, warmup=0, fused_update="on"),
        device=DeviceConfig(num_replicas=1, half=False, seed=7, spans="on"))


def test_live_capture_holds_the_training_threads_steps(tmp_path, server):
    cfg = _cfg(tmp_path)
    loader = get_loader(cfg, num_fake_samples=STEPS * 8)
    cap_dir = str(tmp_path / "cap")
    client = {}

    def posting_iter(epoch, _base=loader.make_train_iter):
        # post from a side thread once the run is past its first
        # (startup) step: the prefetch takes batch 2 while step 1 runs
        for i, batch in enumerate(_base(epoch)):
            if i == 2 and not client:
                client.update(zip(("thread", "out"), _in_thread(
                    capture.capture, f"127.0.0.1:{server.port}", 200,
                    cap_dir)))
            yield batch
    loader = dataclasses.replace(loader, make_train_iter=posting_iter)
    result = fit(cfg, device="cpu", loader=loader, verbose=False)
    client["thread"].join(120)
    assert "error" not in client["out"], client["out"].get("error")
    path, headers = client["out"]["value"]
    assert glob.glob(os.path.join(
        cap_dir, "plugins", "profile", "*", "*.rank0.pt.trace.json.gz")) \
        == [path]
    first = int(headers["X-Capture-First-Step"])
    last = int(headers["X-Capture-Last-Step"])
    steps = int(headers["X-Capture-Steps"])
    assert 1 <= first <= last < len(result.step_losses) == STEPS
    assert steps == last - first + 1
    assert float(headers["X-Capture-Wall-S"]) >= 0.2
    events = capture.load_trace(path)
    main = threading.main_thread().native_id
    dispatch = [e for e in events if e.get("name") == "train/dispatch"
                and e.get("cat") == "user_annotation"]
    assert len(dispatch) == steps
    assert {e["tid"] for e in dispatch} == {main}
    aten = {e["name"] for e in events if e.get("cat") == "cpu_op"
            and e.get("tid") == main and e["name"].startswith("aten::")}
    assert {"aten::convolution", "aten::addmm"} <= aten, sorted(aten)[:20]
    # the slot is free again: a second capture is served by a stub loop
    t, out = _in_thread(_get, server.port, "duration_ms=1")
    _wait_pending()
    for step in range(3):
        profiling.step_boundary(step)
        time.sleep(0.01)
    t.join(60)
    assert out["value"][0] == 200


def test_a_second_request_while_one_is_pending_is_409(server):
    t, out = _in_thread(_get, server.port, "duration_ms=200")
    _wait_pending()
    status, body = _get(server.port)
    assert status == 409 and b"pending or running" in body
    # the run ends before a boundary served it: answered, not left open
    profiling.end_capture("the test's run ended")
    t.join(60)
    status, body = out["value"]
    assert status == 504 and b"the test's run ended before" in body
    assert profiling._request is None


def test_a_capture_while_profiling_trace_is_active_is_409(server, tmp_path):
    with profiling.trace(str(tmp_path)):
        status, body = _get(server.port)
    assert status == 409 and b"another torch.profiler" in body


def test_a_profiler_started_on_the_training_thread_gets_409(server):
    """A profiler the listener cannot see coming (started after the
    post, on the training thread) is found when the capture would start."""
    t, out = _in_thread(_get, server.port, "duration_ms=50")
    _wait_pending()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.step_boundary(0)
    t.join(60)
    status, body = out["value"]
    assert status == 409 and b"another torch.profiler" in body


def test_no_step_boundary_is_504(server, monkeypatch):
    monkeypatch.setattr(profiling, "START_GRACE_S", 0.2)
    t0 = time.perf_counter()
    status, body = _get(server.port, "duration_ms=5")
    assert status == 504 and b"no step boundary came" in body
    assert time.perf_counter() - t0 < 30
    assert profiling._request is None


def test_a_capture_never_stopped_is_504_and_stops_at_the_next_boundary(
        server, monkeypatch):
    monkeypatch.setattr(profiling, "START_GRACE_S", 0.2)
    t, out = _in_thread(_get, server.port, "duration_ms=5")
    _wait_pending()
    assert profiling.step_boundary(4)
    t.join(60)
    status, body = out["value"]
    assert status == 504 and b"started at step 4" in body
    # busy until the training thread stops the profiler
    assert _get(server.port)[0] == 409
    assert profiling.step_boundary(5)
    assert profiling._request is None     # the slot is free at the stop


@pytest.mark.parametrize("query,path,status", [
    ("duration_ms=0", "/capture", 400),
    ("duration_ms=abc", "/capture", 400),
    ("duration_ms=600001", "/capture", 400),
    ("duration_ms=60001", "/capture", 400),
    ("", "/capture", 400),
    ("duration_ms=200", "/profile", 404),
])
def test_bad_requests_are_answered(server, query, path, status):
    got, body = _get(server.port, query, path)
    assert got == status
    assert body.strip()


def test_a_card_trace_without_kernels_is_500(monkeypatch):
    """CUDA activities asked for, steps ran, no ``"cat": "kernel"`` event
    (here: a CPU build, where CUPTI cannot attach): never a success."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    srv = profiling.start_server(0, cuda=True)
    try:
        t, out = _in_thread(_get, srv.port, "duration_ms=1")
        _wait_pending()
        for step in range(4):
            profiling.step_boundary(step)
            torch.ones(8, 8) @ torch.ones(8, 8)
            time.sleep(0.01)
        t.join(60)
    finally:
        srv.stop()
    status, body = out["value"]
    assert status == 500 and b"no kernel event" in body


def test_the_watchdog_is_petted_around_start_and_stop(server):
    pets = []
    assert not profiling.step_boundary(0, lambda: pets.append(1))
    assert pets == []                     # idle: nothing
    t, out = _in_thread(_get, server.port, "duration_ms=1")
    _wait_pending()
    assert profiling.step_boundary(0, lambda: pets.append(1))
    assert len(pets) == 2
    time.sleep(0.01)
    assert profiling.step_boundary(1, lambda: pets.append(1))
    assert len(pets) == 4
    t.join(60)
    assert out["value"][0] == 200


def test_one_server_a_process(server):
    with pytest.raises(ValueError, match="Only one profiler server"):
        profiling.start_server(0)


def test_the_server_binds_all_interfaces(server):
    assert server.httpd.server_address[0] in ("0.0.0.0", "::")


def test_the_profile_port_is_per_local_rank(monkeypatch, capsys):
    """``--profile-port P`` under ``LOCAL_RANK=1`` listens on P + 1 (one
    process per card), and the server stops with the run (here the
    refusal of ``--download``, before anything is built)."""
    seen = {}

    class Stub:
        host, rank = "h", 0

        def __init__(self, port, **kw):
            self.port = port
            seen.update(port=port, **kw)

        def stop(self):
            seen["stopped"] = True
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(profiling, "start_server", Stub)
    rc = torch_cli.main(["--no-cuda", "--profile-port", "7000",
                         "--download", "1"])
    assert rc == 2 and "--download is refused" in capsys.readouterr().err
    assert seen == {"port": 7001, "cuda": False, "stopped": True}


def _client(port, duration_ms, log_dir):
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "byol_tpu_torch", "capture",
         f"127.0.0.1:{port}", str(duration_ms), "--log-dir", str(log_dir)],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_the_client_writes_the_trace_against_a_stub_fit(server, tmp_path):
    proc = _client(server.port, 20, tmp_path)
    try:
        step = 0
        # the stub fit: boundaries on this (the main) thread until the
        # client has its answer
        while proc.poll() is None and step < 100_000:
            with profiling.annotate("train/dispatch"):
                torch.ones(16, 16) @ torch.ones(16, 16)
            profiling.step_boundary(step)
            step += 1
            time.sleep(0.005)
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    (path,) = glob.glob(str(tmp_path / "plugins" / "profile" / "*" /
                            f"{server.host}.rank0.pt.trace.json.gz"))
    assert "capture: steps " in out and path in out
    assert "no kernel events (the run is on the CPU)" in out
    names = {e.get("name") for e in capture.load_trace(path)}
    assert "train/dispatch" in names and "aten::mm" in names


def test_the_client_exits_nonzero_on_a_504(server, tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "START_GRACE_S", 0.2)
    proc = _client(server.port, 5, tmp_path)
    out = proc.communicate(timeout=120)[0]
    assert proc.returncode != 0
    assert "504" in out and "no step boundary came" in out
    assert not (tmp_path / "plugins").exists()


def test_the_client_refuses_a_bad_address(tmp_path):
    assert capture.main(["nohost", "5", "--log-dir", str(tmp_path)]) == 1


def _kineto(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


def test_top_kernels_on_a_synthetic_kineto_trace(tmp_path):
    def k(name, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                "tid": 7, "ts": 0, "dur": dur}
    events = ([{"ph": "M", "name": "process_name", "pid": 0, "tid": 0}]
              + [k("fused_apply_kernel", 300.0)] * 2
              + [k("two_view_kernel", 70.0)] * 4
              + [k("row_norms_kernel", 100.0)]
              + [{"ph": "X", "cat": "cpu_op", "name": "aten::mm",
                  "pid": 1, "tid": 1, "ts": 0, "dur": 5000.0},
                 {"ph": "X", "cat": "gpu_user_annotation",
                  "name": "train/dispatch", "pid": 0, "tid": 7, "ts": 0,
                  "dur": 9000.0},
                 {"ph": "X", "cat": "cuda_runtime",
                  "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 0,
                  "dur": 4.0}])
    path = str(tmp_path / "t.pt.trace.json.gz")
    _kineto(path, events)
    rows = capture.top_kernels(path, 10)
    assert [(r["name"], r["calls"]) for r in rows] == [
        ("fused_apply_kernel", 2), ("two_view_kernel", 4),
        ("row_norms_kernel", 1)]
    assert rows[0]["ms"] == pytest.approx(0.6)
    assert rows[1]["ms"] == pytest.approx(0.28)
    assert sum(r["share"] for r in rows) == pytest.approx(1.0)
    assert rows[2]["share"] == pytest.approx(0.1 / 0.98)
    assert [r["name"] for r in capture.top_kernels(path, 1)] == [
        "fused_apply_kernel"]
    plain = str(tmp_path / "t.json")
    with open(plain, "w") as f:
        json.dump({"traceEvents": events}, f)
    assert capture.top_kernels(plain, None) == rows


def test_profile_path_is_jax_layout_and_unique(tmp_path):
    a = capture.profile_path(str(tmp_path), "h", 3)
    Path(a).write_bytes(b"")
    b = capture.profile_path(str(tmp_path), "h", 3)
    assert a != b
    for p in (a, b):
        rel = Path(p).relative_to(tmp_path).parts
        assert rel[:2] == ("plugins", "profile")
        assert rel[3] == "h.rank3.pt.trace.json.gz"


def test_the_client_imports_no_torch():
    """The client runs from any machine with Python: it imports nothing
    beyond the standard library (neither torch nor JAX)."""
    code = ("import sys; import byol_tpu_torch.observability.capture; "
            "import byol_tpu_torch.__main__; "
            "print(sorted(m for m in ('torch', 'jax', 'numpy', 'byol_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_concurrent_requests_against_a_stepping_run(server):
    """Many clients at once (more threads than cores, a short switch
    interval) against a stub run's boundaries: every reply is a served
    capture or a 409, at least one is served, and the slot ends free."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        clients = [_in_thread(_get, server.port, "duration_ms=1")
                   for _ in range(4 * (os.cpu_count() or 1))]
        step, deadline = 0, time.monotonic() + 120
        while (any(t.is_alive() for t, _ in clients)
               and time.monotonic() < deadline):
            profiling.step_boundary(step)
            step += 1
            time.sleep(0.001)
        for t, _ in clients:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    statuses = sorted(out["value"][0] for _, out in clients)
    assert set(statuses) <= {200, 409} and 200 in statuses, statuses
    assert profiling._request is None


@pytest.mark.parametrize("phase", ["start", "stop"])
def test_a_profiler_fault_is_answered_and_the_run_goes_on(server,
                                                          monkeypatch,
                                                          phase):
    """torch.profiler raising on the training thread is the capture's
    fault: answered 500 with its message, and step_boundary returns."""
    original = getattr(torch.profiler.profile, phase)

    def broken(self):
        if phase == "stop":
            original(self)            # leave no profiler running
        raise RuntimeError(f"broken {phase}")
    monkeypatch.setattr(torch.profiler.profile, phase, broken)
    t, out = _in_thread(_get, server.port, "duration_ms=1")
    _wait_pending()
    step, deadline = 0, time.monotonic() + 60
    while t.is_alive() and time.monotonic() < deadline:
        profiling.step_boundary(step)
        step += 1
        time.sleep(0.005)
    t.join(60)
    monkeypatch.undo()
    status, body = out["value"]
    assert status == 500 and f"broken {phase}".encode() in body
    assert profiling._request is None
    # the listener's turn is over: the next capture is served
    t, out = _in_thread(_get, server.port, "duration_ms=1")
    _wait_pending()
    for step in range(3):
        profiling.step_boundary(step)
        time.sleep(0.01)
    t.join(60)
    assert out["value"][0] == 200


@pytest.mark.parametrize("fault", ["step", "step and sync"])
def test_a_run_that_dies_mid_capture_answers_and_raises_its_own_error(
        tmp_path, monkeypatch, fault):
    """The fit dies while a capture runs (here --fault-at-step; on the
    card, a CUDA fault that the stop's synchronise meets again): fit's
    cleanup ends the capture without raising, the reply says why (200
    with the trace, or 500 when the stop itself failed), and the fit's
    own exception is the one that propagates."""
    cuda = fault == "step and sync"
    if cuda:
        calls = []

        def sync(*a):
            calls.append(1)
            if len(calls) > 1:           # the start's passes, the stop's not
                raise RuntimeError("CUDA error: an illegal memory access "
                                   "was encountered")
        monkeypatch.setattr(torch.cuda, "synchronize", sync)
    srv = profiling.start_server(0, cuda=cuda)
    try:
        cfg = _cfg(tmp_path)
        cfg = dataclasses.replace(cfg, device=dataclasses.replace(
            cfg.device, fault_at_step=5))
        loader = get_loader(cfg, num_fake_samples=STEPS * 8)
        client = {}

        def posting_iter(epoch, _base=loader.make_train_iter):
            for i, batch in enumerate(_base(epoch)):
                if i == 2 and not client:
                    client.update(zip(("thread", "out"), _in_thread(
                        _get, srv.port, "duration_ms=60000")))
                yield batch
        loader = dataclasses.replace(loader, make_train_iter=posting_iter)
        with pytest.raises(SystemExit, match="fault injected at step 5"):
            fit(cfg, device="cpu", loader=loader, verbose=False)
        client["thread"].join(120)
    finally:
        srv.stop()
    status, body = client["out"]["value"]
    if cuda:
        assert status == 500 and b"illegal memory access" in body
        assert b"SystemExit: fault injected at step 5" in body
    else:
        assert status == 200 and body[:2] == b"\x1f\x8b"   # gzip
    assert profiling._request is None


def test_a_capture_stops_at_the_step_cap(server, monkeypatch, tmp_path):
    """However long the duration, a capture holds at most MAX_STEPS steps
    (Kineto keeps the events in host memory until the stop)."""
    monkeypatch.setattr(profiling, "MAX_STEPS", 3)
    t, out = _in_thread(capture.capture, f"127.0.0.1:{server.port}", 60000,
                        str(tmp_path))
    _wait_pending()
    step = 0
    while t.is_alive() and step < 10:
        with profiling.annotate("train/dispatch"):
            torch.ones(8, 8) @ torch.ones(8, 8)
        profiling.step_boundary(step)
        step += 1
    t.join(60)
    assert "error" not in out, out.get("error")
    path, headers = out["value"]
    assert (headers["X-Capture-First-Step"], headers["X-Capture-Steps"]) \
        == ("0", "3")
    assert headers["X-Capture-Note"] == "stopped at the 3-step cap"
    assert sum(e.get("name") == "train/dispatch"
               for e in capture.load_trace(path)) == 3


def test_the_export_counts_kernels_across_its_chunks(tmp_path, monkeypatch):
    """The export is gzipped a chunk at a time; a kernel event cut by a
    chunk's end is counted once, and the file round-trips."""
    monkeypatch.setattr(profiling, "_CHUNK", 7)
    events = [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": i,
               "dur": 1} for i in range(25)]
    events += [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
                "dur": 1}]
    src, dst = str(tmp_path / "t.json"), str(tmp_path / "t.json.gz")
    with open(src, "w") as f:
        json.dump({"traceEvents": events}, f)
    assert profiling._compress(src, dst) == 25
    with gzip.open(dst, "rb") as f, open(src, "rb") as g:
        assert f.read() == g.read()
