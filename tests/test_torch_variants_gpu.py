"""The dense variants' kernel shapes on the card. Every test carries the
``gpu`` marker and skips, from inside the test, where no card is present.
Run them on an H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_variants_gpu.py

This file imports no JAX: the machine with the card has none.

Tolerances: a weight-stream kernel against its plain version, every row
(one head of dh values) within a relative L2 error of 2^-7 (both sum in f32
and round to bf16 once); ``flash_prefill`` every query row within 2^-6
(``chip_smoke.py``'s ``PREFILL_ROW_REL_L2``); granite-8b's fused step
against the plain body run in f32 on the same bf16 weights and pool, 1.8 %
of the largest logit (``chip_smoke.py``'s ``LOGIT_TOL_REL`` for one decode
step)."""
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


def test_qkv_rope_paged_rotates_half_a_head(dev):
    """``qkv_rope_paged`` at chatglm3-6b's widths (D 4096, 32 q / 2 kv
    heads of 128) with ``rope_frac`` 0.5: rows within 2^-7 of the plain
    version; the plain version rotating the whole head differs."""
    from repro_torch.kernels.fused_decode.ops import qkv_rope_paged
    from repro_torch.kernels.fused_decode.ref import (qkv_rope_paged_ref,
                                                      rope_inv_freq)
    rs = np.random.RandomState(4)
    B, D, Hq, Hkv, dh = 8, 4096, 32, 2, 128
    x, scale = _t(rs, (B, D), dev), _t(rs, (D,), dev, 0.1) + 1
    wq = _t(rs, (D, Hq, dh), dev, D ** -0.5)
    wk, wv = (_t(rs, (D, Hkv, dh), dev, D ** -0.5) for _ in range(2))
    pos = torch.as_tensor([0, 14, 15, 16, 99, 254, 300, 511],
                          dtype=torch.int32, device=dev)
    rt.reset_launches()
    got = qkv_rope_paged(x, scale, wq, wk, wv, pos, rope_frac=0.5)
    n = rt.launch_counts()
    assert (n["qkv_rope_paged[partial_rope]"], n["qkv_rope_paged"]) == (1, 0)
    for frac, close in ((0.5, True), (1.0, False)):
        inv = torch.as_tensor(rope_inv_freq(dh, 10000.0, frac), device=dev)
        want = qkv_rope_paged_ref(x, scale, wq, wk, wv, pos, inv)
        err = max(_row_rel_l2(g, w) for g, w in zip(got[:2], want[:2]))
        assert (err <= 2.0 ** -7) == close, (frac, err)
        assert _row_rel_l2(got[2], want[2]) <= 2.0 ** -7


@pytest.mark.parametrize("hq,hkv", [(40, 8), (12, 2), (24, 2)])
def test_flash_prefill_at_the_variants_groups(dev, hq, hkv):
    """``flash_prefill`` at G 5 (qwen2.5-32b), 6 (qwen2-vl-2b) and 12
    (starcoder2-3b), dh 128, causal, two prompts of 300 positions (a
    partial last tile), against its plain version row by row."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rs = np.random.RandomState(hq)
    B, S, dh = 2, 300, 128
    q, k, v = (_t(rs, (B, S, h, dh), dev) for h in (hq, hkv, hkv))
    rt.reset_launches()
    got = attention(q, k, v, causal=True)
    assert rt.launch_counts()["flash_prefill"] == 1
    assert _row_rel_l2(got, attention_ref(q, k, v, causal=True)) <= 2.0 ** -6


def test_granite_fused_step_matches_the_plain_body(dev):
    """One g = 1 paged step of granite-8b at full width, two of its 36
    layers: the fused backend (the three kernels a layer) against the plain
    body in f32 on the same bf16 weights and pool."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import FusedPagedBackend, xla_paged_extend
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=2)
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
    rt.reset_launches()
    lf, _, _ = FusedPagedBackend(cfg).extend(params, pk.clone(), pv.clone(),
                                             tables, lengths, active, toks,
                                             rows - 1)
    torch.cuda.synchronize()
    n = rt.launch_counts()
    assert (n["qkv_rope_paged"], n["decode_paged"],
            n["oproj_ffn_swiglu"]) == (2, 2, 2)
    lr, _, _ = xla_paged_extend(cfg, tree_map(lambda t: t.float(), params),
                                pk.float(), pv.float(), tables, lengths,
                                active, toks, rows - 1)
    lf, lr = lf[active].float(), lr[active].float()
    assert torch.isfinite(lf).all()
    err = float((lf - lr).abs().max())
    assert err <= 0.018 * float(lr.abs().max()), err
