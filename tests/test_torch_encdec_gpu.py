"""The encoder-decoder family's path on the card: ``flash_prefill`` at
Whisper-small's attention shapes (12 heads of 64, not causal): the
encoder's self-attention (S 1500) and the cross-attention of a decoder
(Sq 448 and Sq 4 over Sk 1500), with Sq and Sk around the kernel's tiles;
and a 2 + 2-layer model at Whisper's widths. Every test carries the ``gpu``
marker and skips, from inside a fixture, where no card is present. Run
them on an H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_encdec_gpu.py

This file imports no JAX: the machine with the card has none.

Tolerances: ``flash_prefill`` against its plain version as
``test_torch_prefill_kernels_gpu.py`` holds it: two units in the last place
of the largest value (2^-7 relative, at least 2^-7 absolute) and every
query row within a relative L2 error of 2^-6 (``chip_smoke.py``'s
``PREFILL_ROW_REL_L2``); the keys past the last whole 64-key tile left out
(the tail fault) must read above that. The model's bf16 prefill and decode
steps against the same code in f32 (the bf16 weights upcast, the plain
attention) within 3.4 % of the largest logit, as
``test_torch_mla_gpu.py`` holds its 2-layer model (``chip_smoke.py``'s
``DENSE_LOGIT_TOL_REL``; the full 24-layer model reads 0.5 % there)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref

pytestmark = pytest.mark.gpu

BIG = 1.0e4          # fill past Sq / Sk in the over-allocated buffers
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


@pytest.mark.parametrize("B,Sq,Sk,hkv", [
    (8, 1500, 1500, 12), (8, 448, 1500, 12), (8, 4, 1500, 12),
    (1, 1, 1, 12), (2, 65, 63, 12), (3, 200, 1472, 12), (2, 129, 1473, 4)])
def test_flash_prefill_not_causal_at_sq_and_sk(dev, B, Sq, Sk, hkv):
    """12 q heads (on 12 or 4 kv heads), dh 64, not causal; the first three
    are chip_smoke.py's rows 5W, 5W' and 5W''."""
    rs = np.random.RandomState(Sq * 7 + Sk)
    q, q0 = _padded(rs, B, Sq, 12, 64, dev)
    k, k0 = _padded(rs, B, Sk, hkv, 64, dev)
    v, v0 = _padded(rs, B, Sk, hkv, 64, dev)
    rt.reset_launches()
    got = attention(q, k, v, causal=False)
    again = attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert rt.launch_counts()["flash_prefill"] == 2
    assert got.shape == (B, Sq, 12, 64) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)                 # bit for bit
    want = attention_ref(q0, k0, v0, causal=False)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -7 * max(float(want.float().abs().max()), 1.0)
    assert _row_rel_l2(got, want) <= ROW_REL_L2
    cut = Sk // 64 * 64
    if 0 < cut < Sk:
        tail = attention_ref(q0, k0[:, :cut], v0[:, :cut], causal=False)
        assert _row_rel_l2(tail, want) > ROW_REL_L2


def test_sq_ne_sk_refused_when_causal_or_windowed(dev):
    rs = np.random.RandomState(0)
    q = _padded(rs, 1, 4, 12, 64, dev)[1]
    k = _padded(rs, 1, 40, 12, 64, dev)[1]
    rt.reset_launches()
    for kw in (dict(causal=True), dict(causal=False, window=8)):
        with pytest.raises(ValueError, match="40 keys for 4 queries"):
            attention(q, k, k, **kw)
    assert rt.launch_counts()["flash_prefill"] == 0


def test_two_plus_two_layers_at_whispers_widths(dev):
    """Whisper-small cut to 2 encoder and 2 decoder layers at full width:
    the prefill launches ``flash_prefill`` once per attention (2 + 2 + 2)
    and nothing else, the decode steps none; the prefill's last logits and
    three steps' against the same code in f32."""
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config("whisper-small"), n_layers=2,
                              n_encoder_layers=2)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)
    enc = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen,
                      device=dev)
    toks = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 7)), device=dev)
    rt.reset_launches()
    last, cache = model.prefill(params, {"enc_embeds": enc,
                                         "tokens": toks[:, :4]}, 8)
    torch.cuda.synchronize()
    launches = rt.launch_counts()
    assert launches["flash_prefill"] == 6
    assert sum(launches.values()) == 6
    assert cache["cross_k"].shape == (2, 2, 1500, 12, 64)
    steps = [last]
    for t in range(3):
        lg, cache = model.decode_step(params, cache, toks[:, 4 + t:5 + t],
                                      4 + t)
        steps.append(lg)
    assert sum(rt.launch_counts().values()) == 6
    p32 = tree_map(lambda t: t.float(), params)
    real = L.attention
    L.attention = L.naive_attention
    try:
        with torch.no_grad():
            ref = model.forward(p32, {"enc_embeds": enc,
                                      "tokens": toks}).float()
    finally:
        L.attention = real
    for t, got in enumerate(steps):
        want = ref[:, 3 + t]
        assert torch.isfinite(got.float()).all()
        err = float((got.float() - want).abs().max())
        assert err <= LOGIT_TOL_REL * float(want.abs().max()), (t, err)
