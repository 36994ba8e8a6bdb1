"""The chunkwise mLSTM's backward where forget gates close fast (as at
xlstm-1.3b's full width, whose first train step's gradient norm read NaN
on the H100): the intra-chunk decay's exponent overflows above the
diagonal, and a mask applied after the ``exp`` leaves inf there for the
backward to multiply by a zero gradient. ``mlstm_chunkwise`` masks the
exponent instead: the forward is the same bit for bit, the gradients are
finite."""
import torch

from repro_torch.models.xlstm import mlstm_chunkwise


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
