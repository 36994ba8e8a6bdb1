"""The chunkwise mLSTM's backward where forget gates close fast (as at
xlstm-1.3b's full width, whose first train step's gradient norm read NaN
on the H100): the intra-chunk decay's exponent overflows above the
diagonal, and a mask applied after the ``exp`` leaves inf there for the
backward to multiply by a zero gradient. ``mlstm_chunkwise`` masks the
exponent instead: the forward is the same bit for bit, the gradients are
finite. Under ``PerfOptions.mlstm_bf16`` (q, k, v and the products' other
operands rounded to bf16) the backward runs through the roundings: the
gradients of q, k and v are finite and within TOL of ``jax.grad`` of JAX's
``mlstm_chunkwise`` under the same option (bit-equal in the readings; JAX's
gate gradients are NaN where its decay overflows, so they are not
compared)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import ctx as jctx
from repro.models import xlstm as JX
from repro_torch.distributed import ctx
from repro_torch.models.xlstm import mlstm_chunkwise

# test_torch_xlstm.py's tolerance for the chunkwise core
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, closing):
    g = torch.Generator().manual_seed(seed)
    B, S, H, dh = 2, 64, 2, 8
    q, k, v = (torch.randn((B, S, H, dh), generator=g) for _ in range(3))
    ilog = torch.randn((B, S, H), generator=g).clamp(-10, 10)
    flog = -(100.0 if closing else 1.0) * torch.rand((B, S, H), generator=g)
    return [t.requires_grad_(True) for t in (q, k, v, ilog, flog)]


def _masked_after_exp(q, k, v, ilog, flog, c):
    """The first chunk's intra-chunk decay, masked after the exp."""
    tri = torch.ones((c, c), dtype=torch.bool).tril()
    cum = torch.cumsum(flog[:, :c], dim=1)
    g = ilog[:, :c] - cum
    wmat = torch.where(tri[None, :, :, None],
                       torch.exp(cum[:, :, None] + g[:, None, :]), 0.0)
    return wmat


def test_gradients_finite_where_the_masked_decay_overflows():
    x = _inputs(0, closing=True)
    h, st = mlstm_chunkwise(*x, chunk=32)
    (h.sum() + st["C"].sum() + st["n"].sum()).backward()
    assert all(torch.isfinite(t.grad).all() for t in x)
    # the mask after the exp: the same decay, but its gradient is NaN
    y = _inputs(0, closing=True)
    w = _masked_after_exp(*y, 32)
    w.sum().backward()
    assert not torch.isfinite(y[4].grad).all()


def test_forward_unchanged_by_masking_the_exponent():
    for closing in (False, True):
        x = _inputs(1, closing)
        c = 32
        tri = torch.ones((c, c), dtype=torch.bool).tril()
        cum = torch.cumsum(x[4][:, :c], dim=1)
        g = x[3][:, :c] - cum
        masked_exp = torch.exp(torch.where(
            tri[None, :, :, None], cum[:, :, None] + g[:, None, :],
            float("-inf")))
        assert torch.equal(masked_exp, _masked_after_exp(*x, c))


def _loss(h, st):
    return h.sum() + st["C"].sum() + st["n"].sum()


@pytest.mark.parametrize("closing", [False, True])
def test_gradients_under_mlstm_bf16(closing):
    x = _inputs(2, closing)
    with ctx.perf_options(ctx.PerfOptions(mlstm_bf16=True)):
        _loss(*mlstm_chunkwise(*x, chunk=32)).backward()
    assert all(torch.isfinite(t.grad).all() for t in x)

    def jloss(*a):
        return _loss(*JX.mlstm_chunkwise(*a, chunk=32))

    with jctx.perf_options(jctx.PerfOptions(mlstm_bf16=True)):
        want = jax.grad(jloss, argnums=(0, 1, 2))(
            *(jnp.asarray(t.detach().numpy()) for t in x))
    for name, t, w in zip("qkv", x, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **TOL)
    # the option is read: the f32 core's gradients differ
    y = _inputs(2, closing)
    _loss(*mlstm_chunkwise(*y, chunk=32)).backward()
    assert not torch.equal(y[0].grad, x[0].grad)
