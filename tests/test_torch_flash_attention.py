"""The port's flash attention (K3) held against the JAX package.

The plain PyTorch version — what the wrapper runs on CPU tensors, and what
``chip_smoke.py`` holds the CUDA kernel against on the card — must compute
what the Pallas ``_flash_kernel`` computes, run here in interpret mode as
tests/test_attention.py runs it.  Inputs are drawn with numpy and handed to
both packages.  Tolerances: fp32 1e-5 (summation order only); bf16 2e-2 (p
is rounded to bf16 after normalisation here, before it in the Pallas
kernel; the bound of test_attention.py::test_flash_bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.ops.flash_attention import flash_attention as jax_flash
from byol_tpu_torch.ops import flash_attention as fa
from byol_tpu_torch.ops.attention import dense_attention, get_attention_fn

SHAPES = [(1, 2, 197, 64), (2, 2, 37, 32)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SMS = 132                    # an H100 SXM's SMs, for the launch plan


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_interpret(shape, dtype):
    arrays = _qkv(shape, seed=shape[2])
    want = jax_flash(*(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays),
                     block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_reference(*_torch(arrays, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_dense(dtype):
    arrays = _qkv((2, 3, 50, 32), seed=3)
    q, k, v = _torch(arrays, dtype)
    np.testing.assert_allclose(_f32(fa.flash_attention_reference(q, k, v)),
                               _f32(dense_attention(q, k, v)),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_dense_matches_jax_dense():
    from byol_tpu.ops.attention import dense_attention as jax_dense
    arrays = _qkv((2, 2, 37, 32), seed=4)
    want = jax_dense(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(_f32(dense_attention(*_torch(arrays,
                                                            "float32"))),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v = _torch(_qkv((1, 2, 197, 64), seed=5), "float32")
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v)
    assert fa.LAUNCHES == before
    assert torch.equal(out, fa.flash_attention_reference(q, k, v))


def test_strided_views_match_contiguous():
    """The ViT passes (B, S, H, D)->(B, H, S, D) views of its qkv output."""
    qkv = torch.from_numpy(_qkv((2, 17, 3, 2, 32), seed=6)[0])
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    np.testing.assert_array_equal(
        _f32(fa.flash_attention(q, k, v)),
        _f32(fa.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous())))


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mismatch", "rank"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = _torch(_qkv((1, 2, 8, 32), seed=7), "float32")
    if bad == "head_dim":
        q, k, v = (t[..., :16] for t in (q, k, v))
    elif bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "mismatch":
        k = k[:, :, :4]
    else:
        q, k, v = (t[0] for t in (q, k, v))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)


def test_refuses_gradients():
    q, k, v = _torch(_qkv((1, 2, 8, 32), seed=8), "float32")
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention(q, k, v)


@pytest.mark.parametrize("s", [1, 197, 257])
@pytest.mark.parametrize("bh", [1, 96, 768])
def test_launch_plan_covers_every_query_row_once(bh, s):
    """The bf16 kernel's cut of a head's query rows into work items: each
    row of each head in exactly one item, items of whole 32-row groups
    (a warp's two 16-row m-tiles), K/V resident up to 256 rows, and enough
    items for every SM when the heads alone are fewer."""
    plan = fa.launch_plan(bh, s, SMS)
    covered = np.zeros(s, int)
    for start, stop in fa.plan_rows(plan, s):
        assert 0 <= start < stop <= s
        covered[start:stop] += 1
    assert covered.tolist() == [1] * s
    assert plan.rows_per_block % (fa.GROUP_ROWS if plan.resident else 16) == 0
    assert plan.rows_per_block <= max(fa.RESIDENT_MAX_SEQ, fa.RING_ROWS)
    assert plan.resident == (s <= fa.RESIDENT_MAX_SEQ)
    if not plan.resident:
        assert plan.rows_per_block == fa.RING_ROWS
    elif bh >= SMS:
        assert plan.blocks_per_head == 1
    else:
        assert bh * plan.blocks_per_head >= min(
            bh * -(-s // fa.GROUP_ROWS), bh * fa.MAX_SPLITS, SMS)


def test_attention_registry():
    assert get_attention_fn("dense") is dense_attention
    assert get_attention_fn("flash") is fa.flash_attention
    from byol_tpu_torch.parallel.ring_attention import ring_attention
    assert get_attention_fn("ring") is ring_attention
    with pytest.raises(ValueError, match="unknown"):
        get_attention_fn("bogus")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 12, 197, 64), (2, 4, 100, 32),
                                   (1, 2, 130, 128), (8, 12, 1, 64),
                                   (8, 12, 65, 64), (8, 12, 208, 64),
                                   (4, 12, 256, 128),
                                   (8, 12, 257, 64), (8, 12, 577, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_the_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py runs this comparison on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (t.cuda() for t in _torch(_qkv(shape, seed=9), dtype))
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    np.testing.assert_allclose(
        _f32(got.cpu()), _f32(fa.flash_attention_reference(q, k, v).cpu()),
        rtol=TOL[dtype], atol=TOL[dtype])
