"""The serving engine's CUDA graph per bucket.

On the card (marked ``cuda``; it skips here: a CUDA graph has no CPU
mode): the tiny ViT of tests/test_torch_serving.py under
``attn_impl='flash'`` served by an engine that captures each bucket, held
BITWISE against the same engine kind on the eager path (``graphs=False``)
on the same rows, exact-fill and padded; the captures count as compiles
and never grow after warmup; a replay launches nothing through the
wrappers, and each capture recorded one flash launch per attention layer;
a capture that fails raises.  ``chip_smoke.py`` runs the same comparison
at ViT-B/16.

On the CPU: the engine stays eager whatever ``graphs`` says, and reports
so.
"""
import numpy as np
import pytest
import torch

from byol_tpu_torch.serving.buckets import BucketSpec
from byol_tpu_torch.serving.engine import ServingEngine, kernel_launches
from tests.test_torch_serving import (SIZE, TINY, _rows, _service,
                                      tiny_arch, variables)  # noqa: F401


def test_cpu_engine_stays_eager_and_says_so(tiny_arch,  # noqa: F811
                                            variables):  # noqa: F811
    svc = _service(variables, half=False, normalize=False)
    engine = svc.engine
    assert engine.graphs is False
    engine.warmup()
    d = engine.describe()
    assert d["graphs"] is False and d["capture_launches"] == {}
    assert d["replays"] == {} and engine.compile_count == 1
    out = engine.embed(_rows(3, seed=0))
    assert out.shape == (3, 64) and engine.compile_count == 1


def test_kernel_launches_names_every_wrapper_counter():
    assert set(kernel_launches()) == {"flash_attention", "segment_norms",
                                      "fused_apply", "two_view"}


@pytest.mark.cuda
def test_graph_replays_bitwise_equal_eager_on_the_card(
        tiny_arch, variables):  # noqa: F811
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode "
                    "(chip_smoke.py holds graph against eager on the H100)")
    from byol_tpu_torch.ops import flash_attention as fa
    from byol_tpu_torch.serving.service import ServeConfig, build_service
    from tests.test_torch_serving import _cfg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    svc = build_service(_cfg(False, False),
                        ServeConfig(min_bucket=8, max_bucket=16),
                        params=variables["params"],
                        batch_stats=variables["batch_stats"], device="cuda")
    graph = svc.engine
    eager = ServingEngine(graph.represent, graph.input_shape, graph.buckets,
                          device="cuda", graphs=False)
    graph.warmup()
    eager.warmup()
    assert graph.graphs and not eager.graphs
    warm = graph.compile_count
    assert warm == 2
    d = graph.describe()
    assert d["capture_launches"] == {
        "8": {"flash_attention": TINY["depth"]},
        "16": {"flash_attention": TINY["depth"]}}
    before = fa.LAUNCHES
    for n, seed in ((8, 1), (5, 2), (16, 3), (11, 4)):
        rows = _rows(n, seed)
        got = graph.embed(rows)
        assert got.shape == (n, 64)
        np.testing.assert_array_equal(got, eager.embed(rows))
    # the eager engine launched; the replays did not
    assert fa.LAUNCHES - before == 4 * TINY["depth"]
    assert graph.describe()["replays"] == {"8": 2, "16": 2}
    assert graph.compile_count == warm


@pytest.mark.cuda
def test_a_failed_capture_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")

    def represent(x):
        # a host readback cannot be captured
        return x.reshape(x.shape[0], -1) * x.sum().item()

    engine = ServingEngine(represent, (SIZE, SIZE, 3),
                           BucketSpec(min_bucket=8, max_bucket=8),
                           device="cuda")
    with pytest.raises(RuntimeError):
        engine.warmup()
    assert engine.compile_count == 0
