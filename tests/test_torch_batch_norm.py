"""The fused train-mode BatchNorm (ops/batch_norm.py) and the rule that
picks it.

On the CPU: the plain version of each fused form (the norm alone, + ReLU,
+ residual + ReLU) against the module's own chain (``BatchNorm`` then
``F.relu``, or ``+ residual`` then ``F.relu``) in float64 (outputs, the
gradients of x, the residual, weight and bias, the running statistics; 1e-12
of each tensor's largest magnitude: only the summation order differs);
``update_stats=False`` and a remat recompute leave the running statistics
alone; the dispatch rule (which inputs would take the kernels, and that CPU,
2-D, eval and synced calls never do); the counters; the kernels' grid.
The device test is ``ops/batch_norm.py::on_card``, which these tests set
to True where they run the fused path's plain version on CPU tensors.

On the card (marked ``cuda``, skipped here: the kernels have no CPU mode;
run them there with ``python -m pytest --noconftest -m cuda
tests/test_torch_batch_norm.py``, this file imports no JAX): the kernels
against the module's own path at each ResNet-50 BatchNorm shape of one
view of 256 images, in each form, and a ResNet-50 step under every remat
policy.
"""
import pytest
import torch
import torch.nn.functional as F

from byol_tpu_torch.core import remat
from byol_tpu_torch.models.byol_net import BYOLNet
from byol_tpu_torch.models.layers import BatchNorm, init_params
from byol_tpu_torch.models.resnet import make_resnet
from byol_tpu_torch.ops import batch_norm as bn_ops

CL = torch.channels_last
# (relu, residual) of each fused form: the downsample branch, bn1/bn2 and
# the stem, a block's last BatchNorm
FORMS = {"plain": (False, False), "relu": (True, False),
         "residual_relu": (True, True)}
# the last form with a copy of its output beside it (a block's last
# BatchNorm, whose copy feeds the next block's first conv)
# ResNet-50's BatchNorm inputs at 224 px: (C, H = W), the stem, then each
# stage's stride-1 and strided shapes
RN50_SHAPES = [(64, 112), (64, 56), (256, 56), (128, 56), (128, 28),
               (512, 28), (256, 28), (256, 14), (1024, 14), (512, 14),
               (512, 7), (2048, 7)]


def _close(a, b, rel):
    scale = max(b.abs().max().item(), 1e-30)
    return (a - b).abs().max().item() <= rel * scale


def _bn(c, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen, dtype=dtype) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=gen, dtype=dtype) * 0.3)
        bn.running_mean.copy_(torch.randn(c, generator=gen, dtype=dtype))
        bn.running_var.copy_(torch.rand(c, generator=gen, dtype=dtype) + 0.5)
    return bn


def _twin(bn):
    other = BatchNorm(bn.weight.numel()).to(bn.weight.device,
                                            bn.weight.dtype)
    other.load_state_dict(bn.state_dict())
    return other


def _inputs(shape, dtype, seed, residual):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen, dtype=dtype) * 2 + 0.5)
    x = x.contiguous(memory_format=CL).requires_grad_()
    res = None
    if residual:
        res = torch.randn(shape, generator=gen, dtype=dtype)
        res = res.contiguous(memory_format=CL).requires_grad_()
    return x, res


@pytest.mark.parametrize("update", [True, False], ids=["update", "frozen"])
@pytest.mark.parametrize("form", sorted(FORMS) + ["residual_relu_copy"])
def test_plain_version_matches_module_chain(form, update):
    copy = form.endswith("_copy")
    relu, residual = FORMS[form.removesuffix("_copy")]
    x, res = _inputs((6, 16, 5, 3), torch.float64, 0, residual)
    ref = _bn(16, torch.float64, 1)
    ref.update_stats = update
    want = ref.unfused(x, relu=relu, residual=res)
    # the chain as resnet.py wrote it before the norm took its tail
    chain = _twin(_bn(16, torch.float64, 1))
    chain.update_stats = update
    y = chain.unfused(x)
    if res is not None:
        y = y + res
    assert torch.equal(F.relu(y) if relu else y, want)
    got_bn = _twin(_bn(16, torch.float64, 1))
    got = bn_ops.train_norm(
        x, got_bn.weight, got_bn.bias, got_bn.running_mean,
        got_bn.running_var, residual=res, relu=relu,
        out_dtype=torch.float64, copy_dtype=torch.float64 if copy else None,
        momentum=got_bn.momentum, eps=got_bn.eps, update=update)
    gen = torch.Generator().manual_seed(2)
    g = [torch.randn(want.shape, generator=gen, dtype=torch.float64)
         for _ in range(2)]
    outs_want, outs_got = [want], [got]
    if copy:
        # the copy stands for a consumer's own cast of the output: its
        # gradient joins the output's
        outs_got = list(got)
        assert torch.equal(outs_got[0], outs_got[1])
        outs_want = [want, want.clone()]
    for a in outs_got:
        assert a.dtype == torch.float64 and _close(a, want, 1e-12)
    ins = [x] + ([res] if res is not None else [])
    grads_want = torch.autograd.grad(
        outs_want, ins + [ref.weight, ref.bias], g[:len(outs_want)])
    grads_got = torch.autograd.grad(
        outs_got, ins + [got_bn.weight, got_bn.bias], g[:len(outs_got)])
    for a, b in zip(grads_got, grads_want):
        assert _close(a, b, 1e-12)
    for name in ("running_mean", "running_var"):
        assert _close(getattr(got_bn, name), getattr(ref, name), 1e-12)
    if not update:
        fresh = _bn(16, torch.float64, 1)
        assert torch.equal(got_bn.running_mean, fresh.running_mean)
        assert torch.equal(got_bn.running_var, fresh.running_var)


@pytest.fixture
def card(monkeypatch):
    """Every tensor counts as on the card: the module takes the fused
    path, whose CPU tensors run the plain version; returns the list of
    train_norm calls (their ``relu``, ``residual``, ``out_dtype`` and
    ``copy_dtype``)."""
    calls = []
    real = bn_ops.train_norm

    def counted(*args, **kwargs):
        calls.append((kwargs["relu"], kwargs["residual"] is not None,
                      kwargs["out_dtype"], kwargs["copy_dtype"]))
        return real(*args, **kwargs)
    monkeypatch.setattr(bn_ops, "on_card", lambda x: True)
    monkeypatch.setattr(bn_ops, "train_norm", counted)
    monkeypatch.setattr(bn_ops, "UNFUSED_CUDA_CALLS", 0)
    return calls


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_recomputing_forward_ticks_nothing(request, fused):
    calls = request.getfixturevalue("card") if fused else None
    bn = _bn(16, torch.float32, 3)
    dtype = torch.bfloat16 if fused else torch.float32
    x, _ = _inputs((4, 16, 3, 3), dtype, 4, False)
    before = [bn.running_mean.clone(), bn.running_var.clone()]
    with remat._recompute_context():
        assert remat.recomputing()
        bn(x, relu=True)
    assert torch.equal(bn.running_mean, before[0])
    assert torch.equal(bn.running_var, before[1])
    bn(x, relu=True)
    assert not torch.equal(bn.running_mean, before[0])
    assert not torch.equal(bn.running_var, before[1])
    if fused:
        assert len(calls) == 2


def _x(shape=(2, 16, 3, 3), dtype=torch.bfloat16, cl=True):
    x = torch.randn(shape).to(dtype)
    return x.contiguous(memory_format=CL) if cl and x.dim() == 4 else x


@pytest.mark.parametrize("case,want", [
    ("bf16_channels_last", True), ("float32", False), ("float64", False),
    ("contiguous_nchw", False), ("two_dims", False), ("channels_12", False),
    ("empty", False)])
def test_fusable_inputs(monkeypatch, case, want):
    x = {"bf16_channels_last": lambda: _x(),
         "float32": lambda: _x(dtype=torch.float32),
         "float64": lambda: _x(dtype=torch.float64),
         "contiguous_nchw": lambda: _x(cl=False),
         "two_dims": lambda: _x((4, 16)),
         "channels_12": lambda: _x((2, 12, 3, 3)),
         "empty": lambda: _x((0, 16, 3, 3))}[case]()
    assert not bn_ops.fusable(x)           # a CPU tensor never is
    monkeypatch.setattr(bn_ops, "on_card", lambda t: True)
    assert bn_ops.fusable(x) is want


@pytest.mark.parametrize("case,fused", [
    ("train", True), ("eval", False), ("synced", False),
    ("two_dims", False), ("target", True)])
def test_module_dispatch(card, case, fused):
    bn = _bn(16, torch.float32, 5)
    x = _x((8, 16) if case == "two_dims" else (4, 16, 3, 3))
    if case == "eval":
        bn.eval()
    if case == "synced":
        bn.sync = True                  # one rank: its own batch's statistics
    if case == "target":
        bn.update_stats = False
    before = bn.running_mean.clone()
    out = bn(x, relu=True, cast_to=torch.bfloat16)
    assert len(card) == int(fused)
    assert bn_ops.UNFUSED_CUDA_CALLS == 1 - int(fused)
    if fused:
        assert card[0] == (True, False, torch.bfloat16, None)
        assert out.dtype == torch.bfloat16
        ticked = not torch.equal(bn.running_mean, before)
        assert ticked is (case == "train")
    else:
        assert out.dtype == torch.float32


def test_resnet50_takes_53_fused_calls_per_view(card):
    torch.manual_seed(0)
    net = BYOLNet(make_resnet("resnet50", dtype=torch.bfloat16),
                  num_classes=10, head_latent_size=32, projection_size=16,
                  dtype=torch.bfloat16)
    init_params(net, torch.Generator().manual_seed(0))
    x = torch.rand(2, 32, 32, 3)
    out = net(x.to(torch.bfloat16))
    # stem 1, 16 blocks x 3, 4 downsample branches; the two heads' 2-D
    # BatchNorms take the module's own path
    assert len(card) == 53
    assert bn_ops.UNFUSED_CUDA_CALLS == 2
    bf16, f32 = torch.bfloat16, torch.float32
    forms = {f: card.count(f) for f in set(card)}
    assert forms == {(True, False, f32, None): 1,            # stem
                     (True, False, bf16, None): 32,          # bn1, bn2
                     (True, True, f32, bf16): 16,            # bn3 + copy
                     (False, False, f32, None): 4}           # downsample
    out["prediction"].float().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in net.parameters()
               if p.grad is not None)


@pytest.mark.parametrize("c,hw", RN50_SHAPES,
                         ids=[f"c{c}_hw{hw}" for c, hw in RN50_SHAPES])
def test_grid_covers_the_rows(c, hw):
    rows = 256 * hw * hw
    parts, chunk = bn_ops.grid(rows, c)
    assert parts * chunk >= rows > (parts - 1) * chunk
    vecs = c // bn_ops.VEC
    lanes = min(32, vecs & -vecs)
    assert chunk % (bn_ops.THREADS // lanes) == 0
    # several waves of 132 SMs at every ResNet-50 shape
    assert parts * (vecs // lanes) >= 4 * 132


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the BatchNorm kernels have no CPU "
                    "mode (their plain version is tested above)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _cuda_inputs(c, hw, form, seed):
    """One view of 256 images: a bf16 conv output, fp32 residual."""
    relu, residual = FORMS[form]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((256, c, hw, hw), generator=gen, device="cuda") * 1.5
    x = (x + 0.3).to(torch.bfloat16).contiguous(memory_format=CL)
    res = None
    if residual:
        res = torch.randn((256, c, hw, hw), generator=gen, device="cuda")
        res = res.contiguous(memory_format=CL).requires_grad_()
    return x.requires_grad_(), res


@pytest.mark.cuda
@pytest.mark.parametrize("form,out", [
    ("plain", "fp32"), ("relu", "bf16"), ("relu", "fp32"),
    ("residual_relu", "fp32"), ("residual_relu", "fp32_copy")])
@pytest.mark.parametrize("c,hw", RN50_SHAPES,
                         ids=[f"c{c}_hw{hw}" for c, hw in RN50_SHAPES])
def test_kernels_match_module_path(c, hw, form, out):
    """bf16 outputs equal the module path's after rounding but where the
    statistics' fp32 summation order flips a rounding (at most 1 in 1e3
    elements, by one bf16 step); fp32 outputs and the running statistics
    within 1e-5 of each tensor's largest magnitude (the order of the sums);
    dx (bf16 in both) within 1 % of its largest magnitude and the same
    flips; dweight and dbias, sums over M elements, 1e-5 of their float64
    value, and 2e-3 of the module path's (cuDNN's sums) once the elements
    whose ReLU side differs (an output within rounding of 0) are moved to
    the kernels' side; the residual's gradient equal where the sides
    agree.  With a copy: the copy is
    the output rounded to bf16, and its gradient joins the output's as
    the gradient of the module path's cast does."""
    _card()
    relu, residual = FORMS[form]
    cast_to = torch.bfloat16 if out == "bf16" else None
    copy_to = torch.bfloat16 if out == "fp32_copy" else None
    x, res = _cuda_inputs(c, hw, form, seed=c + hw)
    bn = _bn(c, torch.float32, c).cuda()
    ref = _twin(bn)
    launches = bn_ops.LAUNCHES
    got = bn(x, relu=relu, residual=res, cast_to=cast_to, copy_to=copy_to)
    copy = None
    if copy_to is not None:
        got, copy = got
        assert torch.equal(copy, got.to(torch.bfloat16))
    assert bn_ops.LAUNCHES == launches + 1
    assert got.dtype == (torch.bfloat16 if out == "bf16" else torch.float32)
    assert got.is_contiguous(memory_format=CL)
    want = ref.unfused(x, relu=relu, residual=res)
    gen = torch.Generator(device="cuda").manual_seed(7)
    g, g_copy = (torch.randn(want.shape, device="cuda", generator=gen).to(
        dt).contiguous(memory_format=CL) for dt in (got.dtype, torch.bfloat16))
    ins = [x] + ([res] if res is not None else [])
    outs, grads = [got], [g]
    outs_want, grads_want = [want], [g.float()]
    if copy is not None:
        outs, grads = [got, copy], [g, g_copy]
        outs_want, grads_want = [want, want.to(torch.bfloat16)], [g, g_copy]
    grads_got = torch.autograd.grad(outs, ins + [bn.weight, bn.bias], grads)
    assert bn_ops.LAUNCHES == launches + 2
    grads_want = torch.autograd.grad(
        outs_want, ins + [ref.weight, ref.bias], grads_want)
    torch.cuda.synchronize()
    if out == "bf16":
        rounded = want.to(torch.bfloat16)
        flips = (got != rounded).float().mean().item()
        assert flips <= 1e-3, flips
        assert _close(got.float(), rounded.float(), 2 ** -7)
    else:
        assert _close(got, want, 1e-5)
    # an output within rounding of 0 may take the ReLU's other side in one
    # of the two paths: it changes that element's gradient alone
    agree = (got > 0) == (want > 0)
    assert 1 - agree.float().mean().item() <= 1e-4
    dx, dx_want = grads_got[0], grads_want[0]
    assert dx.dtype == dx_want.dtype == torch.bfloat16
    assert _close(torch.where(agree, dx.float(), 0),
                  torch.where(agree, dx_want.float(), 0), 1e-2)
    assert (dx != dx_want).float().mean().item() <= 0.05
    if res is not None:
        assert torch.equal(torch.where(agree, grads_got[1], 0),
                           torch.where(agree, grads_want[1], 0))
    # dweight and dbias against their float64 value on the kernels' mask
    # (1e-5 of the largest: fp32 partial sums), and against the module
    # path's moved by the elements whose ReLU side differs, within 2e-3
    # of the largest (cuDNN's own sums were seen 1.4e-3 of a channel off
    # at C = 1024)
    flip = ((got > 0).double() - (want > 0).double()) * relu
    g_sum = sum(t.double() for t in grads)
    xd = x.detach().double()
    mean = xd.mean((0, 2, 3), keepdim=True)
    xhat = (xd - mean) * torch.rsqrt(
        ((xd - mean) ** 2).mean((0, 2, 3), keepdim=True) + bn.eps)
    g_kernel = g_sum * (got > 0).double() if relu else g_sum
    truth = [(g_kernel * xhat).sum((0, 2, 3)), g_kernel.sum((0, 2, 3))]
    moved = [(g_sum * flip * xhat).sum((0, 2, 3)),
             (g_sum * flip).sum((0, 2, 3))]
    for a, b, t, d in zip(grads_got[-2:], grads_want[-2:], truth, moved):
        assert _close(a.double(), t, 1e-5)
        assert _close(a.double(), b.double() + d, 2e-3)
    for name in ("running_mean", "running_var"):
        assert _close(getattr(bn, name), getattr(ref, name), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", remat.POLICY_NAMES)
def test_resnet50_step_under_remat_policy(policy):
    """One forward and backward of the online net on both views and a
    forward of the target, under each remat policy: finite loss and
    gradients, 53 fused calls a view-forward (52 more recomputed a view
    under a checkpointing policy: every block's), one backward each, and
    the heads' BatchNorms on the module's own path."""
    _card()
    torch.manual_seed(0)
    nets = [BYOLNet(make_resnet("resnet50", dtype=torch.bfloat16,
                                remat_policy=policy),
                    num_classes=10, dtype=torch.bfloat16) for _ in range(2)]
    for net in nets:
        init_params(net, torch.Generator().manual_seed(0))
        net.cuda().train()
    online, target = nets
    for m in target.modules():
        if isinstance(m, BatchNorm):
            m.update_stats = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    views = [torch.rand((32, 112, 112, 3), device="cuda",
                        generator=gen).to(torch.bfloat16) for _ in range(2)]
    launches, unfused = bn_ops.LAUNCHES, bn_ops.UNFUSED_CUDA_CALLS
    with torch.no_grad():
        tgt = [target(v)["projection"] for v in views]
    assert bn_ops.LAUNCHES - launches == 2 * 53
    on = [online(v)["prediction"] for v in views]
    assert bn_ops.LAUNCHES - launches == 4 * 53
    loss = sum(2 - 2 * F.cosine_similarity(p.float(), t.float()).mean()
               for p, t in zip(on, reversed(tgt)))
    loss.backward()
    torch.cuda.synchronize()
    recomputed = 0 if policy == "none" else 2 * 52
    assert bn_ops.LAUNCHES - launches == 4 * 53 + 2 * 53 + recomputed
    assert bn_ops.UNFUSED_CUDA_CALLS - unfused == 4 * 2
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in online.parameters()
               if p.grad is not None)
