"""ResNet-101's FrozenBN epilogue (``trcnn_torch/ops/frozen_bn.py``).

On the CPU: each form of the epilogue (bare, ReLU, residual, projection),
through the one autograd node the model runs, bit-equal in float32 and
bf16 to the unfused composition the bottleneck ran before (a FrozenBN node
with its written-out backward, then the residual add and the ReLU as
autograd ops, written out here as the reference), forward and the
gradients of x, the residual, p and all eight leaves; and both bottlenecks
(projecting and identity) against that composition.

On the card (marked ``gpu``, skipped without one; the file imports no JAX,
so it runs there without the repository's conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_frozen_bn.py

K7 bit-equal to its plain version at ResNet-101's channel counts with
pixel counts that fill no block, and on a tensor large enough for the
grid to stride; the refusals; a ResNet-101 detect call launching K7
exactly 100 times and the plain version never, a VGG-16 call never.
"""

import pytest
import torch

from trcnn_torch.models import resnet
from trcnn_torch.ops import frozen_bn as fbn
from trcnn_torch.utils import profiling

FORMS = ("bare", "relu", "residual", "proj")
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two torch threads, as ``tests/test_torch_package.py::torch_threads``
    sets for the port's modules (not imported: that module imports JAX,
    which the card's machine lacks)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _UnfusedBN(torch.autograd.Function):
    """The bottleneck's FrozenBN node before the epilogue, as it was."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, eps):
        std = torch.sqrt(var + eps)
        inv = scale / std
        shift = bias - mean * inv
        inv_x = inv.to(x.dtype).view(1, -1, 1, 1)
        ctx.save_for_backward(x, inv_x, scale, mean, inv, std)
        return x * inv_x + shift.to(x.dtype).view(1, -1, 1, 1)

    @staticmethod
    def backward(ctx, g):
        x, inv_x, scale, mean, inv, std = ctx.saved_tensors
        d_shift = g.sum((0, 2, 3), dtype=torch.float32)
        d_inv = (g * x).sum((0, 2, 3), dtype=torch.float32) - mean * d_shift
        d_scale = d_inv / std
        d_var = -d_inv * scale / (std * std) / (2 * std)
        return g * inv_x, d_scale, d_shift, -inv * d_shift, d_var, None


def _unfused(form, x, bn, residual=None, p=None, bn_p=None):
    y = _UnfusedBN.apply(x, bn.scale, bn.bias, bn.mean, bn.var, bn.eps)
    if form == "bare":
        return y
    if form == "residual":
        y = y + residual
    elif form == "proj":
        y = y + _UnfusedBN.apply(p, bn_p.scale, bn_p.bias, bn_p.mean, bn_p.var, bn_p.eps)
    return torch.relu(y)


def _fused(form, x, bn, residual=None, p=None, bn_p=None):
    if form == "bare":
        return bn(x)
    if form == "proj":
        return fbn.frozen_bn(x, bn, proj=(p, bn_p))
    return fbn.frozen_bn(x, bn, residual=residual if form == "residual" else None)


def _bn(c, gen, device="cpu"):
    """A FrozenBatchNorm with random leaves, var > 0."""
    bn = resnet.FrozenBatchNorm(c, device=device)
    with torch.no_grad():
        bn.scale.copy_(torch.randn(c, generator=gen) * 0.5 + 1)
        bn.bias.copy_(torch.randn(c, generator=gen))
        bn.mean.copy_(torch.randn(c, generator=gen))
        bn.var.copy_(torch.rand(c, generator=gen) * 2 + 0.05)
    return bn


def _cl(shape, gen, dtype, scale=3.0):
    """A channels-last NCHW tensor with negative and positive values."""
    return (torch.randn(shape, generator=gen) * scale).to(dtype).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_plain_matches_unfused_composition(form, dtype):
    """Forward and every gradient bit-equal to the unfused composition, and
    the output laid out as its (one image: a channels-last tensor whose
    batch stride no other check would see)."""
    gen = torch.Generator().manual_seed(FORMS.index(form))
    shape = (1, 16, 5, 7)
    bn, bn_p = _bn(16, gen), _bn(16, gen)
    x, r, p = (_cl(shape, gen, dtype) for _ in range(3))
    g = _cl(shape, gen, dtype, 1.0)
    grads = []
    for run in (_unfused, _fused):
        ins = [t.detach().clone().requires_grad_(True) for t in (x, r, p)]
        leaves = list(bn.parameters()) + list(bn_p.parameters())
        for t in leaves:
            t.grad = None
        out = run(form, ins[0], bn, ins[1], ins[2], bn_p)
        out.backward(g)
        grads.append([out] + [t.grad for t in ins + leaves])
    for i, (want, got) in enumerate(zip(*grads)):
        assert (want is None) == (got is None), (form, i)
        if want is not None:
            assert got.dtype == want.dtype and torch.equal(got, want), (form, dtype, i)
            assert got.stride() == want.stride(), (form, dtype, i)


@pytest.mark.parametrize("project", [True, False])
def test_bottleneck_matches_unfused(project):
    """A bf16 bottleneck with random leaves and weights: output and every
    parameter's and the input's gradient bit-equal to the block as it ran
    before the epilogue."""
    gen = torch.Generator().manual_seed(3 + project)
    block = resnet.Bottleneck(32 if project else 64, 16, 2 if project else 1, project)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, resnet.FrozenBatchNorm):
                for t, src in zip(m.parameters(), _bn(m.scale.shape[0], gen).parameters()):
                    t.copy_(src)
            elif isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.2)

    def before(x):
        residual = (_unfused("bare", resnet.conv(x, block.proj), block.proj_bn)
                    if project else x)
        y = _unfused("relu", resnet.conv(x, block.conv1), block.bn1)
        y = _unfused("relu", resnet.conv(y, block.conv2), block.bn2)
        return _unfused("residual", resnet.conv(y, block.conv3), block.bn3, residual)

    x0 = _cl((2, 32 if project else 64, 6, 10), gen, torch.bfloat16)
    g = _cl((2, 64, 3 if project else 6, 5 if project else 10), gen, torch.bfloat16, 1.0)
    runs = []
    for fn in (before, block):
        block.zero_grad(set_to_none=True)
        x = x0.detach().clone().requires_grad_(True)
        out = fn(x)
        out.backward(g)
        runs.append([out, x.grad] + [t.grad for t in block.parameters()])
    for want, got in zip(*runs):
        assert torch.equal(got, want)


# ------------------------------------------------------------------ the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 runs only on the card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _plain_args(form, x, bn, r, p, bn_p):
    """frozen_bn_plain's / frozen_bn_cuda's positional arguments."""
    leaves = (bn.scale, bn.bias, bn.mean, bn.var, bn.eps)
    pl = ((p, bn_p.scale, bn_p.bias, bn_p.mean, bn_p.var, bn_p.eps) if form == "proj"
          else (None,) * 6)
    return (x, *leaves, r if form == "residual" else None, *pl, form != "bare")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [24, 64, 256, 1024, 2048])
def test_k7_matches_plain(dev, c, dtype):
    """Every form bit-equal to the plain version on the card, on 3 x 5 x 7
    pixels (no block filled) and, at 64 channels, on 2 x 161 x 223 (the grid
    strides); 24 channels: three bf16 vectors a row, a row count that 256
    threads do not divide."""
    gen = torch.Generator().manual_seed(c)
    bn, bn_p = _bn(c, gen, dev), _bn(c, gen, dev)
    shapes = [(3, c, 5, 7)] + ([(2, c, 161, 223)] if c == 64 else [])
    for shape in shapes:
        x, r, p = (_cl(shape, gen, dtype).to(dev) for _ in range(3))
        for form in FORMS:
            args = _plain_args(form, x, bn, r, p, bn_p)
            before = profiling.counters["launch.frozen_bn"]
            got = fbn.frozen_bn_cuda(*args)
            assert profiling.counters["launch.frozen_bn"] == before + 1
            want = fbn.frozen_bn_plain(*args)
            torch.cuda.synchronize()
            assert got.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(got, want), (shape, form, dtype)


@pytest.mark.gpu
def test_k7_refuses(dev):
    """An NCHW-contiguous input, C = 12 and a residual without the ReLU
    raise; the wrapper never falls back to the plain version."""
    gen = torch.Generator().manual_seed(0)
    bn = _bn(16, gen, dev)
    x = torch.randn((2, 16, 3, 5), device=dev)
    with pytest.raises(ValueError):
        fbn.frozen_bn_cuda(*_plain_args("relu", x, bn, None, None, None))
    xc = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        fbn.frozen_bn_cuda(*_plain_args("residual", xc, bn, xc, None, None)[:-1], False)
    bn12 = _bn(12, gen, dev)
    x12 = torch.randn((2, 12, 3, 5), device=dev).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        fbn.frozen_bn_cuda(*_plain_args("relu", x12, bn12, None, None, None))


@pytest.mark.gpu
@pytest.mark.parametrize("backbone,want", [("resnet101", 100), ("vgg16", 0)])
def test_detect_launches_k7(dev, monkeypatch, backbone, want):
    """One detect call: K7 once for each of ResNet-101's 100 epilogues (the
    stem's and 33 blocks' three) and the plain version never; VGG-16 none."""
    from trcnn_torch.entry import entry

    plain = []
    monkeypatch.setattr(fbn, "frozen_bn_plain", lambda *a: plain.append(a))
    fn, (model, image, info) = entry(dev, backbone=backbone)
    profiling.reset_counters()
    fn(model, image, info)
    torch.cuda.synchronize()
    assert profiling.counters["launch.frozen_bn"] == want and not plain
