"""The FLOP and byte counts, against the numbers the port's kernel table
(PERF.md, section 6) and the published model sizes give."""
import pytest

from conftest import REPO


def _conf(cell):
    from harness import registry
    return registry.spec(REPO, cell)


def test_resnet50_forward_is_4_1_gmac():
    from harness.flops import resnet_forward_macs
    macs = resnet_forward_macs(_conf("rn50.train.b4096")["arch"], 224)
    assert macs["backbone"] == pytest.approx(4.09e9, rel=0.01)


def test_vit_b16_forward_is_17_6_gmac():
    from harness.flops import vit_forward_macs
    macs = vit_forward_macs(_conf("vit_b16.serve.poisson")["arch"], 224)
    assert macs["backbone"] == pytest.approx(17.56e9, rel=0.01)


@pytest.mark.parametrize("cell, train_gflop, forward_gflop", [
    ("rn50.train.b4096", 65.6, 8.2), ("vit_b16.train.b256", 281.0, 35.1)])
def test_byol_flops_per_image(cell, train_gflop, forward_gflop):
    """Eight forwards of the encoder a training image (the online net's
    forward and backward on two views, the target's forward on two), the
    heads' share on top (under 2 % for ResNet-50, under 0.5 % for
    ViT-B/16)."""
    from harness import registry
    f = registry.flops(_conf(cell))
    assert f["forward"] / 1e9 == pytest.approx(forward_gflop, rel=0.01)
    assert f["train"] / 1e9 == pytest.approx(train_gflop, rel=0.02)


def _flat(family_cell, classes):
    from harness import roofline
    from reference import nets
    conf = dict(_conf(family_cell), num_classes=classes)
    return roofline.flat_elements(nets.param_shapes(conf).values())


def test_flat_buffers_match_the_ports_layouts():
    """35,089,024 and 92,123,008 elements: the kernel table's ResNet-50 and
    ViT-B/16 BYOL layouts (10 classes there; the cells serve 1,000)."""
    assert _flat("rn50.train.b4096", 10) == 35_089_024
    assert _flat("vit_b16.train.b256", 10) == 92_123_008


@pytest.mark.parametrize("cell, k1a_ms, k1b_ms", [
    ("rn50.train.b4096", 0.0838, 0.2933),
    ("vit_b16.train.b256", 0.2200, 0.7700)])
def test_fused_update_bounds(cell, k1a_ms, k1b_ms):
    from harness import roofline as r
    n = _flat(cell, 10)
    assert r.bound_s(r.k1a_bytes(n)) * 1e3 == pytest.approx(k1a_ms, abs=5e-5)
    assert r.bound_s(r.k1b_bytes(n)) * 1e3 == pytest.approx(k1b_ms, abs=5e-5)


def test_k2_and_k3_bounds():
    from harness import roofline as r
    assert r.bound_s(r.k2_bytes(64, 224, 224, 224)) * 1e3 == pytest.approx(
        0.0259, abs=5e-5)
    assert r.k3_bound_s(64, 12, 197, 64) * 1e3 == pytest.approx(
        0.0231, abs=5e-5)
    assert r.k3_bound_s(8, 12, 197, 64) * 1e3 == pytest.approx(
        0.0029, abs=5e-5)


def test_kernel_names_sort_into_the_kernels_kinds():
    from harness.kinds import kind
    assert kind("void byol::flash_fwd_kernel<64>(...)") == "flash_attention"
    assert kind("two_view_kernel<false>") == "K2_two_view"
    assert kind("row_norms_kernel") == "K1a_segment_norms"
    assert kind("segment_reduce_kernel") == "K1a_segment_norms"
    assert kind("fused_apply_kernel") == "K1b_fused_apply"
    assert kind("cudnn::bn_fw_tr_1C11_kernel_NCHW") == "batch_norm"
    assert kind("sm90_xmma_gemm_bf16bf16") == "matmul"
    assert kind("Memcpy HtoD (Pinned -> Device)") == "memcpy"
