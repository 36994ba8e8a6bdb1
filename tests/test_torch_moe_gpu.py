"""The MoE family's path on the card. Every test carries the ``gpu`` marker
and skips, from inside the test, where no card is present. Run them on an
H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_moe_gpu.py

This file imports no JAX: the machine with the card has none.

Tolerances: ``flash_prefill`` every query row within a relative L2 error of
2^-6 of its plain version (``chip_smoke.py``'s ``PREFILL_ROW_REL_L2``);
``moe_apply`` on the card in f32 against the CPU's plain arithmetic within
1e-5 of the largest |output| (both sum in f32, in other orders; TF32 off),
with the same experts chosen and dropped; one paged MoE step (bf16) against
the same plain body in f32 on the same bf16 weights and pool, within 1.8 %
of the largest logit (``chip_smoke.py``'s ``LOGIT_TOL_REL`` for one decode
step), the two routing the step's tokens alike."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import tree_map
from repro_torch.kernels import runtime as rt

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(rs, shape, dev, scale=1.0):
    return torch.as_tensor(rs.standard_normal(shape) * scale,
                           dtype=torch.float32, device=dev).to(torch.bfloat16)


def _row_rel_l2(got, want):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-30)).max())


def _mixtral(**kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mixtral-8x7b"), **kw)


def test_flash_prefill_at_mixtrals_group_past_a_window(dev):
    """G 4 (32 q on 8 kv heads), dh 128, window 192 over two prompts of 500
    positions (a band past the window, a partial last tile)."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rs = np.random.RandomState(3)
    B, S, dh, W = 2, 500, 128, 192
    q, k, v = (_t(rs, (B, S, h, dh), dev) for h in (32, 8, 8))
    rt.reset_launches()
    got = attention(q, k, v, causal=True, window=W)
    assert rt.launch_counts()["flash_prefill"] == 1
    assert _row_rel_l2(got, attention_ref(q, k, v, causal=True,
                                          window=W)) <= 2.0 ** -6
    # the window edge matters: the causal-only output differs
    assert _row_rel_l2(got, attention_ref(q, k, v, causal=True)) > 2.0 ** -6


def test_moe_apply_on_the_card_matches_the_cpu(dev):
    """Mixtral's router and experts at D 4096, E 8, top-2 (F cut to 2048
    so the CPU side stays quick), 96 tokens at cf 1.25 (C 30: drops)."""
    from repro_torch.models import layers as L
    from repro_torch.models.common import init_params
    cfg = _mixtral(moe_d_ff=2048)
    specs = L.moe_specs(cfg)
    p = tree_map(lambda t: t.float(), init_params(
        specs, torch.Generator().manual_seed(1), "cpu"))
    x = torch.as_tensor(np.random.RandomState(2).standard_normal(
        (2, 48, cfg.d_model)), dtype=torch.float32)
    want = L.moe_apply(cfg, p, x)
    pd = tree_map(lambda t: t.to(dev), p)
    got = L.moe_apply(cfg, pd, x.to(dev))
    _, _, top = L.moe_route(cfg, p["router"], x.reshape(-1, cfg.d_model))
    _, _, dtop = L.moe_route(cfg, pd["router"],
                             x.to(dev).reshape(-1, cfg.d_model))
    assert torch.equal(dtop.cpu(), top)          # same choices, same drops
    counts = torch.bincount(top.reshape(-1), minlength=cfg.n_experts)
    assert int((counts - L.moe_capacity(cfg, 96)).clamp_min(0).sum()) > 0
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def test_paged_moe_step_matches_its_f32_recompute(dev):
    """One g = 1 paged step of Mixtral at full width, two of its 32 layers,
    window 0, 8 lanes (C 3 of 16 assignments), on the plain body: bf16
    against the same body in f32 on the same bf16 weights and pool."""
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.serving import XlaPagedBackend, xla_paged_extend
    cfg = _mixtral(n_layers=2, sliding_window=0)
    params = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 dev)
    rs = np.random.RandomState(5)
    B, block, maxb = 8, 16, 32
    rows = B * maxb + 1
    shape = (cfg.n_layers, rows, block, cfg.n_kv_heads, cfg.head_dim)
    pk, pv = _t(rs, shape, dev, 0.5), _t(rs, shape, dev, 0.5)
    tables = torch.as_tensor(rs.permutation(rows - 1)[:B * maxb]
                             .reshape(B, maxb), dtype=torch.int32, device=dev)
    lengths = torch.as_tensor([0, 15, 16, 17, 99, 254, 300, 511],
                              dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[3] = False
    toks = torch.as_tensor(rs.randint(0, cfg.vocab_size, (B, 1)), device=dev)
    routes, real = [], L.moe_route

    def recording(c, router, xt):
        out = real(c, router, xt)
        routes.append(out[2].sort(-1).values)
        return out
    L.moe_route = recording
    try:
        rt.reset_launches()
        lb, _, _ = XlaPagedBackend(cfg).extend(params, pk.clone(),
                                               pv.clone(), tables, lengths,
                                               active, toks, rows - 1)
        torch.cuda.synchronize()
        assert not any(rt.launch_counts().values())   # the plain body
        lr, _, _ = xla_paged_extend(cfg, tree_map(lambda t: t.float(),
                                                  params),
                                    pk.float(), pv.float(), tables, lengths,
                                    active, toks, rows - 1)
    finally:
        L.moe_route = real
    assert L.moe_capacity(cfg, B) == 3
    for a, b in zip(routes[:2], routes[2:]):
        assert torch.equal(a, b)
    lb, lr = lb[active].float(), lr[active].float()
    assert torch.isfinite(lb).all()
    err = float((lb - lr).abs().max())
    assert err <= 0.018 * float(lr.abs().max()), err
