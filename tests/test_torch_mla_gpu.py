"""The MLA family's path on the card: ``flash_prefill`` at DeepSeek-V2's
head widths (q / k of 192, v of 128) and a 2-layer model at DeepSeek's
widths. Every test carries the ``gpu`` marker and skips, from inside a
fixture, where no card is present. Run them on an H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_mla_gpu.py

This file imports no JAX: the machine with the card has none.

Tolerances: ``flash_prefill`` against its plain version as
``test_torch_prefill_kernels_gpu.py`` holds it: two units in the last place
of the largest value (2^-7 relative, at least 2^-7 absolute) and every
query row within a relative L2 error of 2^-6 (``chip_smoke.py``'s
``PREFILL_ROW_REL_L2``); the scale 1/sqrt(dv) in place of 1/sqrt(dk)
must read above that. The model's bf16 prefill and decode step against
the same code in f32 (the bf16 weights upcast, the plain attention) within
3.4 % of the largest logit, ``chip_smoke.py``'s limit for a dense step
(``DENSE_LOGIT_TOL_REL``), at capacity_factor 16 so that no assignment is
dropped and a near-tie routing flip moves one token's mix only."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref

pytestmark = pytest.mark.gpu

BIG = 1.0e4          # fill past S in the over-allocated buffers
ROW_REL_L2 = 2.0 ** -6
LOGIT_TOL_REL = 0.034


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _row_rel_l2(got, want):
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-30)).max())


def _padded(rs, B, S, H, d, dev):
    """A (B, S, H, d) bf16 view into a buffer with 7 positions more per
    lane, filled with BIG past S: a read past S would show."""
    x = torch.as_tensor(rs.standard_normal((B, S, H, d)),
                        dtype=torch.float32, device=dev).to(torch.bfloat16)
    buf = torch.full((B, S + 7, H, d), BIG, dtype=torch.bfloat16, device=dev)
    buf[:, :S] = x
    return buf[:, :S], x


def test_flash_prefill_at_dk_192_dv_128(dev):
    """16 q heads on 16 kv heads (and on 4), causal, S at and around the
    128-row q tiles and the K/V tiles, B 1-4."""
    for S, B, hkv in ((63, 1, 16), (64, 2, 16), (65, 3, 16), (127, 4, 16),
                      (128, 1, 4), (257, 2, 16), (2048, 4, 16)):
        rs = np.random.RandomState(S)
        q, q0 = _padded(rs, B, S, 16, 192, dev)
        k, k0 = _padded(rs, B, S, hkv, 192, dev)
        v, v0 = _padded(rs, B, S, hkv, 128, dev)
        rt.reset_launches()
        got = attention(q, k, v, causal=True)
        again = attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert rt.launch_counts()["flash_prefill"] == 2
        assert got.shape == (B, S, 16, 128) and got.dtype == torch.bfloat16
        assert torch.equal(got, again)             # bit for bit
        want = attention_ref(q0, k0, v0, causal=True)
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -7 * max(float(want.float().abs().max()), 1.0)
        assert _row_rel_l2(got, want) <= ROW_REL_L2, S
        # the scale of dv's width in place of dk's reads above the limit
        wrong = attention_ref(q0 * (192 / 128) ** 0.5, k0, v0, causal=True)
        assert _row_rel_l2(wrong, want) > ROW_REL_L2, S


def test_uninstantiated_widths_raise(dev):
    rs = np.random.RandomState(0)
    for dk, dv in ((192, 64), (128, 64), (96, 96), (256, 128), (192, 192)):
        q, k = (_padded(rs, 1, 64, 2, dk, dev)[1] for _ in range(2))
        v = _padded(rs, 1, 64, 2, dv, dev)[1]
        rt.reset_launches()
        with pytest.raises(ValueError, match="dk, dv"):
            attention(q, k, v, causal=True)
        assert rt.launch_counts()["flash_prefill"] == 0
        # the plain version takes any widths on the CPU
        assert attention(q.cpu(), k.cpu(), v.cpu()).shape == (1, 64, 2, dv)


def test_two_layers_at_deepseeks_widths(dev):
    """DeepSeek-V2-Lite cut to its dense head layer and one MoE layer at
    full width, capacity_factor 16: the prefill launches ``flash_prefill``
    once a layer and nothing else; its last logits and a decode step's
    against the same code in f32."""
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=2,
                              capacity_factor=16.0)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 301)), device=dev)
    rt.reset_launches()
    last, cache = model.prefill(params, {"tokens": toks[:, :300]}, 320)
    torch.cuda.synchronize()
    launches = rt.launch_counts()
    assert launches["flash_prefill"] == 2
    assert sum(launches.values()) == 2
    assert cache["ckv0"].shape == (1, 2, 320, 512)
    assert cache["krope"].shape == (1, 2, 320, 64)
    lg, cache = model.decode_step(params, cache, toks[:, 300:], 300)
    assert sum(rt.launch_counts().values()) == 2
    p32 = tree_map(lambda t: t.float(), params)
    real = L.attention
    L.attention = L.naive_attention
    try:
        with torch.no_grad():
            ref = model.forward(p32, {"tokens": toks}).float()
    finally:
        L.attention = real
    for got, want in ((last, ref[:, 299]), (lg, ref[:, 300])):
        assert torch.isfinite(got.float()).all()
        err = float((got.float() - want).abs().max())
        assert err <= LOGIT_TOL_REL * float(want.abs().max()), err
