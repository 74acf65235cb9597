"""EmbedClient: connection-reusing wire client with deadline + backoff.

A copy of byol_tpu/serving/net/client.py (standard library and numpy): it
talks to either package's server.

One ``http.client.HTTPConnection`` held open per client (HTTP/1.1
keep-alive — the server advertises it), so a request stream pays the TCP
handshake once, not per request.  NOT thread-safe by design — one client per
stream thread (loadgen.py does exactly this); sharing one connection
across threads would interleave frames.

Retry policy: 429 (backpressure) and 503 (draining replica) are the two
*retryable* answers — the server said "not now", not "never".  The
client honors ``Retry-After`` when present, adds decorrelated jitter
(plain exponential backoff synchronizes retry herds — every client that
got the same 429 would come back in lockstep), and gives up when its
attempt budget or overall deadline is spent.  Every other 4xx/5xx raises
immediately: a malformed request does not become well-formed by retrying.
"""
from __future__ import annotations

import http.client
import random
import time
from typing import Optional, Tuple

import numpy as np

from byol_tpu_torch.serving.net import protocol

RETRYABLE = (429, 503)


class WireClientError(RuntimeError):
    """A non-retryable or retry-exhausted wire failure; carries the last
    HTTP status (0 for transport-level failures) and error code."""

    def __init__(self, status: int, code: str, message: str) -> None:
        super().__init__(f"[{status}/{code}] {message}")
        self.status = int(status)
        self.code = code


class EmbedClient:
    """``embed(images) -> (rows, D) float32`` over the wire."""

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = 60.0,
                 max_attempts: int = 5,
                 backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 seed: Optional[int] = None) -> None:
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._rng = random.Random(seed)
        self._conn: Optional[http.client.HTTPConnection] = None

    # ---- connection reuse --------------------------------------------------
    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s)
        return self._conn

    def _drop_connection(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def close(self) -> None:
        self._drop_connection()

    def __enter__(self) -> "EmbedClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- one round trip ----------------------------------------------------
    def _roundtrip(self, method: str, path: str, body: bytes,
                   headers: dict) -> Tuple[int, bytes, dict]:
        conn = self._connection()
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            if resp.will_close:
                self._drop_connection()
            return resp.status, payload, dict(resp.getheaders())
        except (http.client.HTTPException, OSError):
            # a dead keep-alive connection answers nothing — drop it so
            # the retry dials fresh instead of failing the same way
            self._drop_connection()
            raise

    def get(self, path: str) -> Tuple[int, bytes]:
        """One GET (healthz/readyz/statsz); no retries — probes report
        the truth of THIS moment."""
        status, body, _ = self._roundtrip("GET", path, b"", {})
        return status, body

    # ---- the client API ----------------------------------------------------
    def embed(self, images: np.ndarray, *,
              deadline_ms: Optional[float] = None,
              request_id: Optional[str] = None) -> np.ndarray:
        """POST one embed request; retries 429/503 with jittered backoff
        inside the overall deadline; returns ``(rows, D)`` float32."""
        body = protocol.encode_request(images)
        headers = {"Content-Type": "application/octet-stream"}
        if deadline_ms is not None:
            headers["X-Deadline-Ms"] = f"{float(deadline_ms):g}"
        if request_id is not None:
            headers["X-Request-Id"] = request_id
        overall = (time.perf_counter() + deadline_ms / 1e3
                   if deadline_ms is not None else None)
        delay = self.backoff_s
        last: Tuple[int, str, str] = (0, "transport", "never sent")
        for attempt in range(1, self.max_attempts + 1):
            retry_after = None
            try:
                status, payload, resp_headers = self._roundtrip(
                    "POST", "/v1/embed", body, headers)
            except (http.client.HTTPException, OSError) as e:
                last = (0, "transport", repr(e))
            else:
                if status == 200:
                    return protocol.decode_response(payload)
                code, message = _error_fields(payload)
                last = (status, code, message)
                if status not in RETRYABLE:
                    raise WireClientError(status, code, message)
                retry_after = _retry_after_s(resp_headers)
            if attempt >= self.max_attempts:
                break
            # decorrelated jitter: sleep U(backoff_s, delay*3), capped —
            # spreads a refused herd instead of re-synchronizing it.  An
            # explicit Retry-After is a FLOOR the jitter and the cap may
            # not undercut: the server said when the queue will move, and
            # coming back sooner re-hammers exactly what refused us
            sleep = min(self.backoff_max_s,
                        self._rng.uniform(self.backoff_s, delay * 3))
            if retry_after is not None:
                sleep = max(sleep, retry_after)
            if overall is not None and \
                    time.perf_counter() + sleep >= overall:
                break                    # the budget outlives no retry
            time.sleep(sleep)
            delay = min(self.backoff_max_s, max(delay, sleep))
        raise WireClientError(
            last[0], last[1],
            f"gave up after {attempt} attempt(s): {last[2]}")


def _error_fields(payload: bytes) -> Tuple[str, str]:
    """Best-effort decode of the server's JSON error body."""
    import json
    try:
        obj = json.loads(payload)
        return str(obj.get("error", "unknown")), \
            str(obj.get("message", ""))[:200]
    except (ValueError, AttributeError):
        return "unknown", payload[:200].decode("latin-1")


def _retry_after_s(headers: dict) -> Optional[float]:
    for k, v in headers.items():
        if k.lower() == "retry-after":
            try:
                return float(v)
            except ValueError:
                return None
    return None


def parse_address(spec: str) -> Tuple[str, int]:
    """``HOST:PORT`` -> tuple, with the actionable error on a typo."""
    host, sep, port = spec.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"--http address {spec!r} must be HOST:PORT "
            "(e.g. 127.0.0.1:8700 or 0.0.0.0:8700)")
    try:
        return host, int(port)
    except ValueError:
        raise ValueError(
            f"--http port {port!r} is not an integer") from None


def wait_until_ready(host: str, port: int, *, timeout_s: float = 30.0,
                     poll_s: float = 0.1) -> bool:
    """Poll ``/readyz`` until 200 (True) or the timeout (False) — the
    startup barrier a client uses before driving traffic."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            conn = http.client.HTTPConnection(host, port, timeout=2.0)
            try:
                conn.request("GET", "/readyz")
                if conn.getresponse().status == 200:
                    return True
            finally:
                conn.close()
        except (OSError, http.client.HTTPException):
            pass
        time.sleep(poll_s)
    return False


__all__ = ["EmbedClient", "WireClientError", "parse_address",
           "wait_until_ready", "RETRYABLE"]
