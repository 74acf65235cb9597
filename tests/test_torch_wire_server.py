"""The port's wire front end (serving/net/server.py, client.py) over a real
socket, against a stub engine (no model), and the serve CLI with --http.

Mirrors the JAX package's tests/test_net.py layers 2-4 on the port's
EmbeddingService: each mapped 4xx leaves the server serving; admission
answers before the body is read (413, 411, 400 on a bad deadline);
deadlines give 408 and saturation 429 with Retry-After, inside the
budget; /readyz flips to 503 at the drain while /healthz stays 200, and a
drain racing live clients strands nothing; the client retries 429/503
and raises at once on other 4xx.  Statuses and error codes are compared
exactly; the stub's embeddings bitwise.

Every server binds 127.0.0.1:0, and every socket, join and future has a
timeout of 10 s or less.
"""
import http.client
import json
import struct
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from byol_tpu_torch.serving.batcher import DynamicBatcher, ServiceClosed
from byol_tpu_torch.serving.buckets import BucketSpec
from byol_tpu_torch.serving.cli import main as serve_main
from byol_tpu_torch.serving.net import protocol
from byol_tpu_torch.serving.net.client import (EmbedClient, WireClientError,
                                               wait_until_ready)
from byol_tpu_torch.serving.net.server import WireServer
from byol_tpu_torch.serving.service import EmbeddingService
from tests.test_torch_loader import one_thread  # noqa: F401

SHAPE = (4, 4, 3)
T = 10.0                                 # seconds: every socket and wait


class _StubEngine:
    """The engine surface the worker drives (dispatch/readback): the
    "embedding" of a row is its first 4 values, optionally after a
    delay."""

    input_shape = SHAPE

    def __init__(self, dispatch_delay_s=0.0):
        self.buckets = BucketSpec(min_bucket=8, max_bucket=16)
        self.compile_count = len(self.buckets.sizes)
        self.dispatch_delay_s = dispatch_delay_s

    def warmup(self):
        pass

    def dispatch(self, rows, timeline=None):
        if self.dispatch_delay_s:
            time.sleep(self.dispatch_delay_s)
        if timeline is not None:
            t = time.perf_counter()
            timeline.update(stage=t, dispatch=t)
        return types.SimpleNamespace(
            out=rows.reshape(rows.shape[0], -1)[:, :4].astype(np.float32),
            rows=int(rows.shape[0]),
            bucket=self.buckets.bucket_for(rows.shape[0]))

    def readback(self, inflight, timeline=None):
        if timeline is not None:
            timeline["readback"] = time.perf_counter()
        return inflight.out

    def describe(self):
        return {"buckets": list(self.buckets.sizes), "stub": True}


def _stub_service(dispatch_delay_s=0.0, max_queue=64, max_wait_s=0.002,
                  events=None):
    svc = EmbeddingService(
        _StubEngine(dispatch_delay_s),
        DynamicBatcher(max_batch=16, max_queue=max_queue,
                       max_wait_s=max_wait_s), events=events)
    return svc.start(warmup=False)


def _stub_server():
    return WireServer(_stub_service(), "127.0.0.1", 0,
                      default_deadline_ms=T * 1e3).start()


@pytest.fixture(scope="module")
def stub_server():
    """One server for the tests that leave it serving."""
    server = _stub_server()
    yield server
    server.drain(grace_s=0.0, timeout_s=T)


@pytest.fixture()
def fresh_server():
    """A server of the test's own, for the tests that drain it."""
    server = _stub_server()
    yield server
    server.drain(grace_s=0.0, timeout_s=T)


def _raw_post(host, port, body, headers=None):
    conn = http.client.HTTPConnection(host, port, timeout=T)
    try:
        conn.request("POST", "/v1/embed", body=body,
                     headers={"Content-Type": "application/octet-stream",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _frame_bytes(header: dict, payload: bytes) -> bytes:
    head = json.dumps(header).encode()
    return struct.pack(">I", len(head)) + head + payload


def _good_body(rows=1):
    return protocol.encode_request(
        np.arange(rows * 48, dtype=np.float32).reshape(rows, *SHAPE))


def _zeros():
    return np.zeros((1, *SHAPE), np.float32)


class TestServer:
    def test_embed_roundtrip_and_request_id_echo(self, stub_server):
        host, port = stub_server.address
        status, payload, headers = _raw_post(
            host, port, _good_body(2), {"X-Request-Id": "req-abc"})
        assert status == 200
        assert headers.get("X-Request-Id") == "req-abc"
        np.testing.assert_array_equal(protocol.decode_response(payload),
                                      [[0.0, 1.0, 2.0, 3.0],
                                       [48.0, 49.0, 50.0, 51.0]])

    def test_keepalive_answers_are_not_held_by_nagle(self, stub_server):
        """With Nagle on, the body of each answer on a kept-alive
        connection waits for the delayed ACK of its headers: >= 40 ms a
        request on Linux, every request.  The fastest of 10 must be well
        under that."""
        host, port = stub_server.address
        with EmbedClient(host, port, timeout_s=T) as c:
            c.embed(_zeros())
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                c.embed(_zeros())
                times.append(time.perf_counter() - t0)
        assert min(times) < 0.030, times

    @pytest.mark.parametrize("body,status,code", [
        (b"garbage", 400, "bad_frame"),
        (_frame_bytes({"v": 1, "dtype": "float64",
                       "shape": [1, 4, 4, 3]}, bytes(8 * 48)),
         415, "unsupported_dtype"),
        (_frame_bytes({"v": 1, "dtype": "uint8", "shape": [1, 4, 4, 3]},
                      bytes(10)), 400, "payload_size_mismatch"),
        (_frame_bytes({"v": 1, "dtype": "uint8", "shape": [17, 4, 4, 3]},
                      bytes(17 * 48)), 413, "too_many_rows"),
        (_frame_bytes({"v": 2, "dtype": "uint8", "shape": [1, 4, 4, 3]},
                      bytes(48)), 400, "bad_version"),
    ])
    def test_each_4xx_leaves_the_server_serving(self, stub_server, body,
                                                status, code):
        host, port = stub_server.address
        got, payload, _ = _raw_post(host, port, body)
        assert got == status
        assert json.loads(payload)["error"] == code
        ok, ok_payload, _ = _raw_post(host, port, _good_body())
        assert ok == 200
        assert protocol.decode_response(ok_payload).shape == (1, 4)

    def test_oversized_content_length_refused_before_read(self,
                                                          stub_server):
        host, port = stub_server.address
        # the declared body is never sent: a server that tried to read it
        # would wait out the socket timeout instead of answering
        t0 = time.perf_counter()
        status, payload, _ = _raw_post(
            host, port, b"",
            {"Content-Length": str(stub_server.max_body_bytes + 1)})
        assert status == 413 and time.perf_counter() - t0 < T / 2
        assert json.loads(payload)["error"] == "too_large"
        assert _raw_post(host, port, _good_body())[0] == 200

    def test_missing_content_length_is_411(self, stub_server):
        host, port = stub_server.address
        conn = http.client.HTTPConnection(host, port, timeout=T)
        try:
            conn.putrequest("POST", "/v1/embed", skip_host=False)
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            conn.send(b"0\r\n\r\n")
            resp = conn.getresponse()
            assert resp.status == 411
            assert json.loads(resp.read())["error"] == "length_required"
        finally:
            conn.close()

    def test_expired_deadline_is_408(self, stub_server):
        host, port = stub_server.address
        status, payload, _ = _raw_post(host, port, _good_body(),
                                       {"X-Deadline-Ms": "0"})
        assert status == 408
        assert json.loads(payload)["error"] == "deadline_expired"
        assert _raw_post(host, port, _good_body())[0] == 200

    @pytest.mark.parametrize("bad", ["abc", "NaN", "inf", "-inf",
                                     "-Infinity"])
    def test_invalid_deadline_is_400(self, stub_server, bad):
        host, port = stub_server.address
        status, payload, _ = _raw_post(host, port, _good_body(),
                                       {"X-Deadline-Ms": bad})
        assert status == 400
        assert json.loads(payload)["error"] == "bad_deadline"

    def test_health_ready_stats_endpoints(self, stub_server):
        host, port = stub_server.address
        assert wait_until_ready(host, port, timeout_s=T)
        with EmbedClient(host, port, timeout_s=T) as c:
            assert c.get("/healthz")[0] == 200
            assert c.get("/readyz")[0] == 200
            c.embed(_zeros())
            status, body = c.get("/statsz")
            assert status == 200
            stats = json.loads(body)
            assert stats["draining"] is False
            assert stats["serve_stats"]["requests"] >= 1.0
            assert stats["serve_stats"]["wire"]["status"]["200"] >= 1
            assert set(stats["serve_stats"]["wire"]["phase_ms"]) == {
                "read", "parse", "wait", "write"}
            assert stats["engine"]["stub"] is True
            assert c.get("/nope")[0] == 404

    def test_saturated_queue_answers_429_within_budget(self):
        svc = _stub_service(dispatch_delay_s=1.0, max_queue=1,
                            max_wait_s=0.0)
        server = WireServer(svc, "127.0.0.1", 0,
                            default_deadline_ms=T * 1e3).start()
        host, port = server.address
        deadline_ms = 400.0
        results, lock = [], threading.Lock()

        def one():
            t0 = time.perf_counter()
            with EmbedClient(host, port, timeout_s=T, max_attempts=1) as c:
                try:
                    c.embed(_zeros(), deadline_ms=deadline_ms)
                    status = 200
                except WireClientError as e:
                    status = e.status
            with lock:
                results.append((status, time.perf_counter() - t0))

        threads = [threading.Thread(target=one) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
        try:
            assert not any(t.is_alive() for t in threads)
            statuses = [s for s, _ in results]
            assert len(results) == 6
            assert 429 in statuses, statuses
            assert all(s in (200, 408, 429) for s in statuses), statuses
            assert all(el < deadline_ms / 1e3 + 2.0
                       for _, el in results), results
            # Retry-After rides a 429
            status, _, headers = _raw_post(host, port, _good_body(),
                                           {"X-Deadline-Ms": "50"})
            assert status in (408, 429)
            if status == 429:
                assert "Retry-After" in headers
        finally:
            server.drain(grace_s=0.0, timeout_s=T)


class TestLifecycle:
    def test_readyz_flips_503_during_drain_healthz_stays_200(self,
                                                             fresh_server):
        host, port = fresh_server.address
        with EmbedClient(host, port, timeout_s=T) as c:
            assert c.get("/readyz")[0] == 200
            fresh_server.begin_drain()
            assert c.get("/readyz")[0] == 503
            assert c.get("/healthz")[0] == 200
            with EmbedClient(host, port, timeout_s=T,
                             max_attempts=1) as c2:
                with pytest.raises(WireClientError) as e:
                    c2.embed(_zeros())
            assert e.value.status == 503

    def test_drain_vs_inflight_hammer_strands_nothing(self, tmp_path):
        from byol_tpu_torch.observability.events import RunLog, read_events
        log = RunLog(str(tmp_path / "serve.jsonl"))
        svc = _stub_service(dispatch_delay_s=0.005, events=log)
        server = WireServer(svc, "127.0.0.1", 0,
                            default_deadline_ms=T * 1e3).start()
        host, port = server.address
        stats, errors, lock = {"ok": 0, "refused": 0}, [], threading.Lock()

        def spam(idx):
            with EmbedClient(host, port, timeout_s=T, max_attempts=1,
                             seed=idx) as c:
                while True:
                    try:
                        out = c.embed(_zeros())
                    except WireClientError as e:
                        with lock:
                            if e.status in (0, 503):   # drained: done
                                stats["refused"] += 1
                            else:
                                errors.append(str(e))
                        return
                    with lock:
                        if out.shape != (1, 4):
                            errors.append(f"bad shape {out.shape}")
                            return
                        stats["ok"] += 1

        threads = [threading.Thread(target=spam, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.2)                  # let traffic build
        clean = server.drain(grace_s=0.0, timeout_s=T)
        for t in threads:
            t.join(timeout=T)
        assert not any(t.is_alive() for t in threads)
        assert clean, "drain timed out with requests in flight"
        assert not errors, errors
        assert stats["ok"] > 0 and stats["refused"] == 6
        assert server.inflight == 0
        with pytest.raises(ServiceClosed):
            svc.submit(_zeros())
        # every admitted request's answer is in the log that the drain's
        # final stats window closed
        log.close()
        answered = sum(e["wire"]["status"].get("200", 0)
                       for e in read_events(str(tmp_path / "serve.jsonl"))
                       if e["kind"] == "serve_stats" and "wire" in e)
        assert answered == stats["ok"]


    def test_drain_stops_the_service_after_the_last_answer_is_counted(
            self, tmp_path):
        """The admission slot is released after the answer is counted: a
        slow meter must not let the drain's final stats window close
        without the in-flight request's 200."""
        from byol_tpu_torch.observability.events import RunLog, read_events
        from byol_tpu_torch.serving.meter import ServingMeter

        class SlowMeter(ServingMeter):
            def record_wire(self, status, phases):
                time.sleep(1.5)      # longer than the listener's close
                super().record_wire(status, phases)

        path = str(tmp_path / "serve.jsonl")
        log = RunLog(path)
        svc = EmbeddingService(
            _StubEngine(dispatch_delay_s=0.2),
            DynamicBatcher(max_batch=16, max_wait_s=0.0), events=log,
            meter=SlowMeter()).start(warmup=False)
        server = WireServer(svc, "127.0.0.1", 0,
                            default_deadline_ms=T * 1e3).start()
        host, port = server.address
        got = []
        client = threading.Thread(
            target=lambda: got.append(_raw_post(host, port, _good_body())))
        client.start()
        t0 = time.perf_counter()
        while server.inflight == 0 and time.perf_counter() - t0 < T:
            time.sleep(0.005)
        assert server.drain(grace_s=0.0, timeout_s=T)
        client.join(timeout=T)
        log.close()
        assert not client.is_alive() and got[0][0] == 200
        final = [e for e in read_events(path) if e["kind"] == "serve_stats"]
        assert final[-1]["wire"]["status"] == {"200": 1}


# ---------------------------------------------------------------------------
# the client against a scripted server
# ---------------------------------------------------------------------------

class _ScriptedHandler(BaseHTTPRequestHandler):
    """Answers POSTs from a scripted status list (latched at the end)."""

    script = [200]
    calls = 0

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802 — stdlib handler contract
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        cls = type(self)
        status = cls.script[min(cls.calls, len(cls.script) - 1)]
        cls.calls += 1
        if status == 200:
            body = protocol.encode_response(np.zeros((1, 4), np.float32))
            ctype = "application/octet-stream"
        else:
            body = json.dumps({"error": "scripted",
                               "message": "go away"}).encode()
            ctype = "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if status in (429, 503):
            self.send_header("Retry-After", "0.01")
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture()
def scripted_server():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _ScriptedHandler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=T)


def _client(httpd, **kw):
    host, port = httpd.server_address[:2]
    return EmbedClient(host, port, timeout_s=5.0, backoff_s=0.005,
                       backoff_max_s=0.02, seed=0, **kw)


class TestClientBackoff:
    def test_retries_429_then_succeeds(self, scripted_server):
        _ScriptedHandler.script, _ScriptedHandler.calls = [429, 429, 200], 0
        with _client(scripted_server, max_attempts=5) as c:
            assert c.embed(_zeros()).shape == (1, 4)
        assert _ScriptedHandler.calls == 3

    def test_gives_up_after_attempt_budget(self, scripted_server):
        _ScriptedHandler.script, _ScriptedHandler.calls = [503], 0
        with _client(scripted_server, max_attempts=2) as c:
            with pytest.raises(WireClientError) as e:
                c.embed(_zeros())
        assert e.value.status == 503 and _ScriptedHandler.calls == 2

    def test_non_retryable_4xx_raises_immediately(self, scripted_server):
        _ScriptedHandler.script, _ScriptedHandler.calls = [415], 0
        with _client(scripted_server, max_attempts=5) as c:
            with pytest.raises(WireClientError) as e:
                c.embed(_zeros())
        assert e.value.status == 415 and _ScriptedHandler.calls == 1

    def test_retry_stops_inside_the_overall_deadline(self,
                                                     scripted_server):
        _ScriptedHandler.script, _ScriptedHandler.calls = [429], 0
        t0 = time.perf_counter()
        with _client(scripted_server, max_attempts=1000) as c:
            with pytest.raises(WireClientError) as e:
                c.embed(_zeros(), deadline_ms=200.0)
        assert e.value.status == 429
        assert time.perf_counter() - t0 < 2.0


# ---------------------------------------------------------------------------
# the serve CLI with --http
# ---------------------------------------------------------------------------

CLI = ["--no-cuda", "--arch", "vit_s16", "--attn-impl", "flash",
       "--image-size-override", "32", "--no-half", "--max-batch", "8",
       "--http", "127.0.0.1:0", "--serve-trace", "off"]


def test_cli_smoke_over_the_wire(one_thread, tmp_path,  # noqa: F811
                                 capsys):
    from byol_tpu_torch.observability.events import read_events
    events = tmp_path / "serve.jsonl"
    assert serve_main(CLI + ["--smoke", "8", "--smoke-streams", "2",
                             "--serve-events", str(events)]) == 0
    out = capsys.readouterr()
    assert "serve: wire front end at http://127.0.0.1:" in out.out
    assert "loadgen: 8/8 ok" in out.err
    kinds = {e["kind"]: e for e in read_events(str(events))}
    assert kinds["run_header"]["config"]["serving"]["http"] == \
        "127.0.0.1:0"
    wire = kinds["serve_stats"]["wire"]
    assert wire["status"] == {"200": 8}


def test_cli_smoke_fails_when_a_request_fails(one_thread,  # noqa: F811
                                              tmp_path, capsys):
    # a 0.001 ms budget is spent before any request is queued: every
    # request is a 408, and the smoke must say so with its exit code
    rc = serve_main(CLI + ["--smoke", "4", "--smoke-streams", "2",
                           "--http-deadline-ms", "0.001",
                           "--log-dir", str(tmp_path)])
    assert rc != 0
    assert "408" in capsys.readouterr().err


def test_cli_refuses_a_bad_address(tmp_path, capsys):
    rc = serve_main(CLI[:-4] + ["--http", "8700", "--smoke", "1",
                                "--log-dir", str(tmp_path)])
    assert rc == 2
    assert "HOST:PORT" in capsys.readouterr().err


def test_cli_with_http_and_no_card_exits_2(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go to it")
    rc = serve_main(CLI[1:] + ["--smoke", "2"])
    assert rc == 2
    assert "--no-cuda" in capsys.readouterr().err
