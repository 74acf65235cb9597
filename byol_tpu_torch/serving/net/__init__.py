"""byol_tpu_torch/serving/net/ — the wire front end over EmbeddingService.

Counterpart of byol_tpu/serving/net/, standard library and numpy only:

- :mod:`~byol_tpu_torch.serving.net.protocol` — wire format v1 (strict-JSON
  header + raw tensor payload) and its typed 4xx error map, byte for byte
  the JAX package's;
- :mod:`~byol_tpu_torch.serving.net.server` — the ThreadingHTTPServer
  adapter over ``EmbeddingService.submit`` with deadline-aware admission
  and a graceful drain;
- :mod:`~byol_tpu_torch.serving.net.client` — connection-reusing client
  with a deadline and jittered backoff on 429/503;
- :mod:`~byol_tpu_torch.serving.net.loadgen` — the closed-loop multi-stream
  request generator behind ``--smoke``.
"""
