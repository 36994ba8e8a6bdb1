"""Training on the card: the ``flash_prefill`` LSE forward and the
``flash_prefill_bwd`` kernels against their plain versions, one train step
of two reduced families, and the families whose kernels have no backward
refusing to train. Every test carries the ``gpu`` marker and skips, from
inside a fixture, where no card is present. Run them on an H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_train_gpu.py

This file imports no JAX: the machine with the card has none.

Tolerances: dq, dk, dv each within a relative L2 error of 2^-6 of
``attention_bwd_ref`` in f32 on the same bf16 inputs (the kernel rounds p
and ds to bf16 for its products and its outputs to bf16: a few bf16 units);
o within 2^-6 a row of the plain version; lse within 1e-3 of the f32
log-sum-exp (approximate exp2 over at most S terms). A train step's first
loss on the card (bf16) within 2 % of the same step's loss in f32 on the
CPU on the same weights."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime as rt

pytestmark = pytest.mark.gpu

BWD_REL_L2 = 2.0 ** -6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(rs, shape, dev):
    return torch.as_tensor(rs.standard_normal(shape), dtype=torch.float32,
                           device=dev).to(torch.bfloat16)


def _rel_l2(got, want):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


# (d, G, S, causal, window): every width, G 1 / 4 (and 2), S not a multiple
# of the 64-row tiles, causal, causal with a window, a window alone
CASES = [(32, 1, 100, True, 0), (64, 4, 257, True, 0),
         (128, 1, 300, True, 0), (128, 4, 200, True, 48),
         (64, 2, 130, False, 40), (128, 4, 1000, True, 300),
         (32, 4, 65, True, 17)]


@pytest.mark.parametrize("d,G,S,causal,window", CASES)
def test_backward_kernel_matches_plain(dev, d, G, S, causal, window):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    rs = np.random.RandomState(d + G + S)
    B, Hkv = 2, 2
    q = _t(rs, (B, S, Hkv * G, d), dev)
    k, v = _t(rs, (B, S, Hkv, d), dev), _t(rs, (B, S, Hkv, d), dev)
    do = _t(rs, (B, S, Hkv * G, d), dev)
    rt.reset_launches()
    o, lse = ops.attention_lse(q, k, v, causal=causal, window=window)
    got = ops.attention_bwd(q, k, v, o, lse, do, causal=causal,
                            window=window)
    again = ops.attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, a), f"{name}: two calls differ"
        err = _rel_l2(g, w)
        assert err < BWD_REL_L2, f"{name}: rel L2 {err}"
    n = rt.launch_counts()
    assert n["flash_prefill[lse]"] == 1 and n["flash_prefill_bwd"] == 2
    # the same through autograd: attention routes to FlashAttention
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.attention(qg, kg, vg, causal=causal, window=window)
    out.backward(do)
    for name, t, g in zip(("dq", "dk", "dv"), (qg, kg, vg), got):
        assert torch.equal(t.grad, g), name
    assert torch.equal(out, o)


def test_lse_matches_plain(dev):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    rs = np.random.RandomState(3)
    for d, G, S, causal, window in CASES[:5]:
        q = _t(rs, (2, S, 2 * G, d), dev)
        k, v = _t(rs, (2, S, 2, d), dev), _t(rs, (2, S, 2, d), dev)
        o, lse = ops.attention_lse(q, k, v, causal=causal, window=window)
        o_ref, lse_ref = attention_lse_ref(q, k, v, causal=causal,
                                           window=window)
        torch.cuda.synchronize()
        assert lse.shape == (2, 2 * G, S) and lse.dtype == torch.float32
        assert float((lse - lse_ref).abs().max()) < 1e-3, (d, G, S)
        err = float(((o.float() - o_ref.float()).norm(dim=-1)
                     / o_ref.float().norm(dim=-1).clamp_min(1e-30)).max())
        assert err < BWD_REL_L2, (d, G, S, err)
        # the plain instantiation gives the same o
        assert torch.equal(ops.attention(q, k, v, causal=causal,
                                         window=window), o)


def _train_one_step(cfg, dev, seed=0):
    from repro_torch.bridge import tree_map
    from repro_torch.distributed import stepfn
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(seed), dev)
    cpu32 = tree_map(lambda t: t.detach().float().cpu(), params)
    rs = np.random.RandomState(seed)
    toks = torch.as_tensor(rs.randint(0, cfg.vocab_size, (2, 97)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    opt = AdamWConfig(warmup_steps=2, decay_steps=4)
    step = stepfn.make_train_step(cfg, opt)
    rt.reset_launches()
    state, m = step(stepfn.init_train_state(params),
                    {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    counts = rt.launch_counts()
    _, m32 = stepfn.make_train_step(cfg, opt)(
        stepfn.init_train_state(cpu32), batch)
    return state, m, m32, counts


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x7b"])
def test_one_train_step_on_the_card(dev, arch):
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(arch))
    state, m, m32, counts = _train_one_step(cfg, dev)
    loss, loss32 = float(m["loss"]), float(m32["loss"])
    assert np.isfinite(loss) and abs(loss - loss32) < 0.02 * abs(loss32)
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    L = cfg.n_layers
    # remat: each layer's forward twice, its backward once
    assert counts["flash_prefill[lse]"] == 2 * L, counts
    assert counts["flash_prefill_bwd"] == L, counts
    assert counts["flash_prefill"] == 0, counts
    assert int(state["opt"]["step"]) == 1


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-small",
                                  "deepseek-v2-lite-16b"])
def test_training_without_a_backward_kernel_raises(dev, arch):
    """lru_scan has no backward (RuntimeError from the launch guard); MLA's
    (192, 128) and Whisper's full attention are outside the backward
    kernel's contract (ValueError). Neither returns weights without a
    gradient."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import stepfn
    from repro_torch.models import get_model
    cfg = reduced(get_config(arch))
    if arch == "deepseek-v2-lite-16b":       # MLA at its real head widths
        cfg = dataclasses.replace(cfg, qk_nope_dim=128, qk_rope_dim=64,
                                  v_head_dim=128)
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0), dev)
    before = {k: v.clone() for k, v in params["final_norm"].items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.zeros(2, cfg.encoder_seq, cfg.d_model,
                                          device=dev)
    step = stepfn.make_train_step(cfg)
    with pytest.raises((RuntimeError, ValueError),
                       match="no backward|backward kernel"):
        step(stepfn.init_train_state(params), batch)
    for k, v in params["final_norm"].items():
        assert torch.equal(v, before[k])
