"""Training on the card: the ``flash_prefill`` LSE forward and the
``flash_prefill_bwd`` kernels against their plain versions, the
``lru_scan_bwd`` kernel against its plain version, and one train step of
each reduced family with its launch counts. Every test carries the ``gpu`` marker and skips, from
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
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.as_tensor(rs.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32)
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


# the reduced configs at their family's real attention heads (``reduced(...,
# full_heads=True)``), so a step reaches each backward instantiation the
# full-size family trains through: RecurrentGemma's 16 q heads on one kv
# head of 256 (window 32), MLA's (192, 128), Whisper's heads of 64 (its
# encoder and cross-attention FULL, here over 200 frames: off the key tiles)
FAMILY_EXTRA = {
    "recurrentgemma-9b": {},
    "deepseek-v2-lite-16b": {},
    "whisper-small": dict(encoder_seq=200),
    "xlstm-1.3b": {},
}


@pytest.mark.parametrize("arch", sorted(FAMILY_EXTRA))
def test_family_train_step_on_the_card(dev, arch):
    """One train step of each family the earlier card tests left out, its
    loss within 2 % of the f32 CPU step's, a finite non-zero gradient norm,
    and exactly the launches the code implies (``stepfn.kernel_launches``);
    no square ``flash_prefill`` and no other kernel."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import stepfn
    cfg = dataclasses.replace(reduced(get_config(arch), full_heads=True),
                              **FAMILY_EXTRA[arch])
    state, m, m32, counts = _train_one_step(cfg, dev)
    loss, loss32 = float(m["loss"]), float(m32["loss"])
    assert np.isfinite(loss) and abs(loss - loss32) < 0.02 * abs(loss32)
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    want = stepfn.kernel_launches(cfg)
    assert {k: n for k, n in counts.items() if n} == \
        {k: n for k, n in want.items() if n}, counts
    assert int(state["opt"]["step"]) == 1


def test_lru_scan_backward_matches_plain(dev):
    """``lru_scan_bwd`` at S off its 16-step chunks (1, 17, 300) and D off
    the 128-thread blocks, against ``lru_scan_bwd_ref`` in f32 (relative L2
    1e-5: one f32 fma a step in both, summed in another order by the plain
    version's doubling scan), two calls bit-equal, and through autograd
    (``lru_scan`` under grad routes to ``LruScan``)."""
    from repro_torch.kernels.lru_scan.ops import lru_scan, lru_scan_bwd
    from repro_torch.kernels.lru_scan.ref import lru_scan_bwd_ref
    rs = np.random.RandomState(11)
    for B, S, D in ((2, 1, 64), (1, 17, 200), (3, 300, 130)):
        a = torch.as_tensor(rs.uniform(0.5, 1.0, (B, S, D)),
                            dtype=torch.float32, device=dev)
        b, dh = (torch.as_tensor(rs.standard_normal((B, S, D)),
                                 dtype=torch.float32, device=dev)
                 for _ in range(2))
        with torch.no_grad():
            h = lru_scan(a, b)
        rt.reset_launches()
        got, again = lru_scan_bwd(a, h, dh), lru_scan_bwd(a, h, dh)
        torch.cuda.synchronize()
        assert rt.launch_counts()["lru_scan_bwd"] == 2
        for name, g, x, w in zip(("da", "db"), got, again,
                                 lru_scan_bwd_ref(a, h, dh)):
            assert torch.equal(g, x), name
            assert _rel_l2(g, w) < 1e-5, (name, B, S, D)
        ag, bg = (t.clone().requires_grad_(True) for t in (a, b))
        lru_scan(ag, bg).backward(dh)
        assert torch.equal(ag.grad, got[0]) and torch.equal(bg.grad, got[1])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "deepseek-v2-lite-16b",
                                  "whisper-small"])
def test_trainer_on_the_card(dev, arch, capsys):
    """``launch/train.py --reduced`` on the card (its default device) for
    the families that train through the new kernels: the loss falls over 6
    steps (the trainer's own check) and the kernels launched (``--reduced``
    keeps each family's attention heads: MLA at DeepSeek's (192, 128))."""
    from repro_torch.launch import train
    rt.reset_launches()
    losses = train.main(["--arch", arch, "--reduced", "--steps", "6",
                         "--batch", "2", "--seq", "96"])
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert f"loss {losses[0]:.4f} -> {losses[-1]:.4f} OK" in \
        capsys.readouterr().out
    n = rt.launch_counts()
    assert n["flash_prefill_bwd"] > 0 and n["flash_prefill"] == 0
    if arch == "recurrentgemma-9b":
        assert n["lru_scan_bwd"] > 0
