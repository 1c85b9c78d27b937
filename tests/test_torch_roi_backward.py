"""The port's RoI-pool backward (the plain version kernel K4 is held
against) and the autograd path through ``roi_max_pool``, on the CPU.

Against the JAX package's custom VJP (``roi_pool_backward_xla``) and its
numpy oracle ``roi_pool_backward_oracle_numpy``: with integer-valued
gradients every sum is exact in any order, so the results must be
bit-equal, tie cases included (a tied bin sends its whole gradient to the
column-major-first argmax cell).  With real-valued gradients the float32
sums may be taken in another order: within 1e-5 of the largest |dfeat|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trcnn.ops.roi_pool import roi_max_pool as jax_roi_max_pool
from trcnn.ops.roi_pool import roi_pool_backward_oracle_numpy
from trcnn_torch.ops import roi_pool

T = torch.from_numpy
_TORCH = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _case(seed, b=2, h=38, w=64, c=16, r=24, plateaus=False):
    """RoIs inside the map (as proposals are), one beyond it (empty) and
    one clipped; optional constant plateaus that make exact ties."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, h, w, c)).astype(np.float32)
    if plateaus:
        feat[:, 4:12, 6:20] = 3.0
        feat[:, 20:30, 30:50] = 0.0
    x1 = rng.uniform(0, w * 16 - 100, (b, r))
    y1 = rng.uniform(0, h * 16 - 60, (b, r))
    rois = np.stack([x1, y1, np.minimum(x1 + rng.uniform(5, 600, (b, r)), w * 16 - 1),
                     np.minimum(y1 + rng.uniform(5, 400, (b, r)), h * 16 - 1)], -1)
    rois[:, 0] = (w * 16 + 100, 10, w * 16 + 200, 90)      # beyond the map: empty
    rois[:, 1] = (-40, -30, 200, 150)                      # clipped
    g = rng.integers(-4, 5, (b, r, 7, 7, c)).astype(np.float32)
    return feat, rois.astype(np.float32), g


def _jax_vjp(feat, rois, g, dtype):
    """dfeat of the JAX pool at feat in ``dtype`` (its pooled output, and so
    the cotangent, is float32 either way)."""
    pool = jax.vmap(functools.partial(jax_roi_max_pool, out_size=7, spatial_scale=1 / 16))
    f = jnp.asarray(feat).astype(dtype)
    _, vjp = jax.vjp(lambda x: pool(x, jnp.asarray(rois)), f)
    return np.asarray(vjp(jnp.asarray(g))[0]).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("plateaus", [False, True])
def test_backward_bit_equal_to_jax_vjp(dtype, plateaus):
    feat, rois, g = _case(1, plateaus=plateaus)
    want = _jax_vjp(feat, rois, g, dtype)
    tdt = _TORCH[dtype]
    got = roi_pool.roi_pool_backward_plain(T(feat).to(tdt), T(rois), T(g).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.abs(want).sum() > 0


def test_backward_bit_equal_to_oracle_beyond_map_size():
    """Tie-heavy values from {0, 1, 2}, and a RoI larger than the map: the
    window sized from the bounds routes like the numpy oracle."""
    feat, rois, g = _case(2, b=1, h=21, w=30, c=8, r=12)
    feat = np.random.default_rng(3).integers(0, 3, feat.shape).astype(np.float32)
    rois[0, 2] = (-300, -300, 900, 700)
    got = roi_pool.roi_pool_backward_plain(T(feat), T(rois), T(g))
    np.testing.assert_array_equal(got[0].numpy(),
                                  roi_pool_backward_oracle_numpy(feat[0], rois[0], g[0]))


@pytest.mark.parametrize("second", [(2, 3), (4, 2)], ids=["column_tie", "row_tie"])
def test_tied_bin_has_one_winner(second):
    """The fixtures of tests/test_roi_pool_pallas.py: bin (0, 0) spans rows
    0..5 and columns 0..9; two cells share its max.  Column tie: the first
    column wins; row tie within a column: the first row.  Autograd through
    roi_max_pool gives the same single winner, not an even split.  (At
    ``_case``'s shapes, so that JAX compiles its VJP once for the module:
    every RoI is the same box, and only the first one's bin (0, 0) of
    image 0 has a gradient.)"""
    feat = np.zeros((2, 38, 64, 16), np.float32)
    feat[0, 2, 2] = 5.0
    feat[0, second[0], second[1]] = 5.0
    rois = np.broadcast_to(np.float32([0.0, 0.0, 1015.0, 599.0]), (2, 24, 4)).copy()
    g = np.zeros((2, 24, 7, 7, 16), np.float32)
    g[0, 0, 0, 0] = 2.0
    want = _jax_vjp(feat, rois, g, np.float32)
    got = roi_pool.roi_pool_backward_plain(T(feat), T(rois), T(g)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2, 2] == 2.0).all() and (got[0, second[0], second[1]] == 0.0).all()

    x = T(feat).requires_grad_()
    roi_pool.roi_max_pool(x, T(rois)).backward(T(g))
    np.testing.assert_array_equal(x.grad.numpy(), got)


def test_autograd_equals_explicit_backward():
    """Through the autograd Function: the forward is the plain pool, the
    gradient the explicit backward (ReLU-like zeros make many ties), and
    the RoIs get none."""
    feat, rois, g = _case(4, plateaus=True)
    feat = np.maximum(feat, 0.0)
    x = T(feat).requires_grad_()
    r = T(rois).requires_grad_()
    out = roi_pool.roi_max_pool(x, r)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  roi_pool.roi_max_pool_plain(T(feat), T(rois)).numpy())
    out.backward(T(g))
    np.testing.assert_array_equal(x.grad.numpy(),
                                  roi_pool.roi_pool_backward_plain(T(feat), T(rois), T(g)).numpy())
    assert r.grad is None


def test_backward_real_valued_gradient_within_tolerance():
    feat, rois, _ = _case(5)
    g = np.random.default_rng(6).standard_normal((2, 24, 7, 7, 16)).astype(np.float32)
    want = _jax_vjp(feat, rois, g, np.float32)
    got = roi_pool.roi_pool_backward_plain(T(feat), T(rois), T(g)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_backward_wrapper_refuses_cpu_tensors():
    feat, rois, g = _case(7, b=1, r=2)
    with pytest.raises(ValueError):
        roi_pool.roi_pool_backward_cuda(T(feat), T(rois), T(g))
