"""``trace.reduce`` over stub profiler events: a device event counts
whole when the host launched it inside the window, whatever the card's
clock says, and not when the host launched it before; busy time stays
the union of the device's events clipped to the window, and the launched
events' union is taken whole.  ``device_idle_pct.train`` reads that union
against the untraced step, signed."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from conftest import BENCH
from harness import registry, trace

MS = 1_000_000                      # ns


class Evt:
    def __init__(self, name, device, t0_ms, t1_ms, corr, annotation=False):
        self._name, self._device = name, device
        self._t0, self._t1 = int(t0_ms * MS), int(t1_ms * MS)
        self._corr, self._annotation = corr, annotation

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._t0

    def end_ns(self):
        return self._t1

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._annotation


def _host(name, t0_ms, corr, annotation=False, t1_ms=None):
    return Evt(name, DeviceType.CPU, t0_ms,
               t0_ms + 0.01 if t1_ms is None else t1_ms, corr, annotation)


def _card(name, t0_ms, t1_ms, corr):
    return Evt(name, DeviceType.CUDA, t0_ms, t1_ms, corr)


def _reduce(evts):
    # the window: host 10 to 110 ms
    window = [_host(trace.WINDOW, 10, 1, annotation=True, t1_ms=110),
              Evt(trace.WINDOW, DeviceType.CUDA, 12, 150, 1, True)]
    return trace.reduce(SimpleNamespace(events=lambda: window + evts,
                                        perf_start=100.0))


GEMM = "sm90_xmma_gemm_bf16bf16"


def test_attributes_device_events_by_their_launch():
    t = _reduce([
        # launched before the window, run inside it on the card
        _host("cudaLaunchKernel", 8, 50),
        _card("fused_apply_kernel", 12, 14, 50),
        # a host operator numbered in its own series: shares id 52 with a
        # launch, and decides nothing
        _host("aten::mm", 5, 52),
        _host("cudaLaunchKernelExC", 20, 52),
        _card(GEMM, 20, 30, 52),
        _host("cuLaunchKernel", 29, 53),
        _card(GEMM, 30, 35, 53),
        # one graph launch, two kernels
        _host("cudaGraphLaunch", 60, 54),
        _card("two_view_kernel<false>", 61, 62, 54),
        _card("void byol::flash_fwd_kernel<64>(...)", 62, 63, 54),
        # launched at the window's end; the card's clock puts it 40 ms
        # past the host's end
        _host("cudaLaunchKernel", 100, 55),
        _card("row_norms_kernel", 150, 160, 55),
        # no launch in the trace at all: launched before the profiler
        _card("segment_reduce_kernel", 11, 13, 99),
    ])
    assert t.window_s == pytest.approx(0.1)
    assert t.kind_s == pytest.approx({
        "matmul": 0.015, "K2_two_view": 0.001, "flash_attention": 0.001,
        "K1a_segment_norms": 0.010})
    assert t.kind_calls == {"matmul": 2, "K2_two_view": 1,
                            "flash_attention": 1, "K1a_segment_norms": 1}
    assert t.name_s == pytest.approx({
        GEMM: 0.015, "two_view_kernel<false>": 0.001,
        "void byol::flash_fwd_kernel<64>(...)": 0.001,
        "row_norms_kernel": 0.010})
    assert t.name_calls[GEMM] == 2
    # busy: 11-14, 20-35 and 61-63 ms, the device events clipped to the
    # window, launched in it or not
    assert t.busy_s == pytest.approx(0.020)
    # launched in the window, each whole: 20-35, 61-63 and 150-160 ms
    assert t.launched_busy_s == pytest.approx(0.027)


# the kernel names of test_harness_counts.py's
# test_kernel_names_sort_into_the_kernels_kinds, and their kinds
NAMES = [
    ("void byol::flash_fwd_kernel<64>(...)", "flash_attention"),
    ("two_view_kernel<false>", "K2_two_view"),
    ("row_norms_kernel", "K1a_segment_norms"),
    ("segment_reduce_kernel", "K1a_segment_norms"),
    ("fused_apply_kernel", "K1b_fused_apply"),
    ("cudnn::bn_fw_tr_1C11_kernel_NCHW", "batch_norm"),
    ("sm90_xmma_gemm_bf16bf16", "matmul"),
    ("Memcpy HtoD (Pinned -> Device)", "memcpy"),
]


@pytest.mark.parametrize("name, kind", NAMES)
def test_a_launched_event_reads_under_its_kind_and_its_name(name, kind):
    t = _reduce([_host("cudaLaunchKernel", 40, 7),
                 _card(name, 41, 44, 7)])
    assert t.kind_s == pytest.approx({kind: 0.003})
    assert t.kind_calls == {kind: 1}
    assert t.name_s == pytest.approx({name: 0.003})
    assert t.name_calls == {name: 1}


@pytest.mark.parametrize("busy_s, idle_pct", [(0.018, 10.0), (0.021, -5.0)])
def test_the_train_idle_share_is_signed(busy_s, idle_pct):
    """Two traced steps against an untraced step of 10 ms: a card busier
    under the profiler than the untraced step lasts reads below 0."""
    t = trace.Trace(perf_start=0.0, window_s=0.03, busy_s=0.02,
                    launched_busy_s=busy_s, kind_s={}, kind_calls={},
                    name_s={}, name_calls={}, gaps=[])
    read = registry.layer_metric({"bench_dir": str(BENCH)},
                                 "device_idle_pct.train")
    ctx = {"trace": t, "out": {"layer": {"step_s": 0.01, "steps_traced": 2}}}
    assert read(ctx) == pytest.approx(idle_pct)
