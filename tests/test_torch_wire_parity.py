"""Embeddings over the wire: the port's WireServer in front of a real
service, held against the in-process path and the JAX package.

The tiny ViT of tests/test_torch_serving.py (``attn_impl='flash'``, flax
weights through ``convert.from_flax``), fp32, one service and server per
module on 127.0.0.1:0:

- float32 rows fetched over HTTP are BITWISE equal to the in-process
  ``service.embed`` of the same rows (exact-fill and padded buckets);
- uint8 rows are BITWISE equal to float32 ``u8 / 255`` rows;
- both are within fp32 1e-4 of JAX ``frozen_representation_fn``;
- the service's ``serve_stats`` carries the ``wire`` block through the
  strict run log.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest

from byol_tpu.training.linear_eval import frozen_representation_fn
from byol_tpu_torch.observability.events import RunLog, read_events
from byol_tpu_torch.serving.net.client import EmbedClient
from byol_tpu_torch.serving.net.server import WireServer
from byol_tpu_torch.serving.service import ServeConfig, build_service
from tests.test_torch_loader import one_thread  # noqa: F401
from tests.test_torch_serving import (SIZE, _cfg, _jax_net, _rows,
                                      tiny_arch, variables)  # noqa: F401

TOL = 1e-4                               # fp32
T = 10.0                                 # seconds: every socket and wait


@pytest.fixture(scope="module")
def served(one_thread, tiny_arch, variables):  # noqa: F811 — imported
    # one stats window for the module: no emit resets it between tests
    service = build_service(
        _cfg(False, False),
        ServeConfig(min_bucket=8, max_bucket=8, stats_interval_s=1e9),
        params=variables["params"], batch_stats=variables["batch_stats"],
        device="cpu").start()
    server = WireServer(service, "127.0.0.1", 0,
                        default_deadline_ms=T * 1e3).start()
    yield service, server
    server.drain(grace_s=0.0, timeout_s=T)


@pytest.fixture(scope="module")
def jax_represent(variables):  # noqa: F811
    fn = frozen_representation_fn(_jax_net(False), variables["params"],
                                  variables["batch_stats"], half=False,
                                  normalize=False)
    return lambda rows: np.asarray(fn(jnp.asarray(rows)))


def _client(server):
    host, port = server.address
    return EmbedClient(host, port, timeout_s=T)


@pytest.mark.parametrize("n", [8, 5, 1])       # exact fill, padded, 1 row
def test_float32_over_the_wire_bitwise_equals_in_process(served,
                                                         jax_represent, n):
    service, server = served
    rows = _rows(n, seed=20 + n)
    with _client(server) as c:
        got = c.embed(rows, deadline_ms=T * 1e3)
    want = service.embed(rows, timeout=T)
    assert got.shape == (n, 64) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, jax_represent(rows), rtol=TOL, atol=TOL)


def test_uint8_over_the_wire_bitwise_equals_float_u8_over_255(
        served, jax_represent):
    _, server = served
    u8 = np.random.RandomState(7).randint(0, 256, size=(6, SIZE, SIZE, 3),
                                          dtype=np.uint8)
    as_float = u8.astype(np.float32) / np.float32(255.0)
    with _client(server) as c:
        got_u8 = c.embed(u8)
        got_f32 = c.embed(as_float)
    np.testing.assert_array_equal(got_u8, got_f32)
    np.testing.assert_allclose(got_u8, jax_represent(as_float), rtol=TOL,
                               atol=TOL)


def test_serve_stats_carries_the_wire_block(served, tmp_path):
    service, server = served
    with _client(server) as c:
        c.embed(_rows(2, seed=3))
    # the handler counts its answer after writing it, then frees its slot
    t0 = time.perf_counter()
    while server.inflight and time.perf_counter() - t0 < T:
        time.sleep(0.001)
    snap = service.meter.snapshot(time.perf_counter(), reset=False)
    wire = snap["wire"]
    assert wire["status"].get("200", 0) >= 1
    assert set(wire["phase_ms"]) == {"read", "parse", "wait", "write"}
    assert all(v >= 0.0 for v in wire["phase_ms"].values())
    path = str(tmp_path / "serve.jsonl")
    with RunLog(path) as log:
        service.meter.emit(log, time.perf_counter(), reset=False,
                           compile_count=service.engine.compile_count)
    (event,) = list(read_events(path))
    assert event["kind"] == "serve_stats"
    assert event["wire"]["http_requests"] == wire["http_requests"]
