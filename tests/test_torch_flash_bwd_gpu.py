"""``flash_prefill_bwd`` at the edges of its tiles on the card:
``bwd_kernel``'s 128-key tiles (64 keys a warpgroup, 64-row q tiles) at d
32 / 64 / 128 and ``wide_kernel``'s 64-key tiles (each warpgroup half of
the 64-row q tile's columns) at d 256 and (192, 128). Lengths S 1, 63,
64, 65, 127, 129, 257 and 513; windows of 17, 64 and 128, with and
without the causal mask (a band narrower than a tile, one that is neither
causal nor fills a tile, and S below a tile); G 1, 2, 4, 8, 16, with
``wide_kernel``'s q heads split over CTAs and not; every width.
Every test carries the ``gpu`` marker and skips, from inside a fixture,
where no card is present. Run them on an H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_flash_bwd_gpu.py

This file imports no JAX: the machine with the card has none.

Tolerance: dq, dk, dv each within a relative L2 error of 2^-6 of
``attention_bwd_ref`` in f32 on the same bf16 inputs (the kernel rounds p
and ds to bf16 for its products and its outputs to bf16: a few bf16
units). At S 1 every row attends its one key with p = 1, so ds = p (dp -
di) and with it dq and dk vanish: both results are rounding noise there,
and those two are held instead to an absolute 2^-6 of dv's largest
element. Where every key shares a large offset, the offset cancels in dq
and dk and scales up ds's bf16 rounding past 2^-6 (an H100 read dq 4.1e-2
at q 4, k -4 + noise): there dq and dk are held to the offset-free columns
(``test_full_masks_the_keys_past_sk``), or every gradient to the plain
formulas at the kernels' bf16 rounding points
(``test_full_shared_key_offset_is_rounding``). Two calls agree bit for
bit, and the gradients autograd takes through ``ops.attention`` equal the
direct call's."""
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


# (d, G, S, causal, window)
CASES = [
    # causal: S below, at and past each tile's edges
    (32, 1, 1, True, 0), (64, 2, 63, True, 0), (128, 1, 65, True, 0),
    (32, 8, 127, True, 0), (64, 1, 129, True, 0), (128, 8, 257, True, 0),
    # causal with a window: narrower than a 64-row tile, one tile, two
    (128, 2, 257, True, 17), (64, 4, 300, True, 64),
    (32, 2, 513, True, 128), (128, 8, 129, True, 64),
    # a window alone (no causal mask): keys after each row are attended
    (128, 1, 129, False, 17), (64, 8, 257, False, 64),
    (128, 4, 300, False, 128), (32, 1, 65, False, 17),
    (128, 8, 1, False, 17), (64, 1, 63, False, 128),
]


@pytest.mark.parametrize("d,G,S,causal,window", CASES)
def test_backward_at_tile_edges(dev, d, G, S, causal, window):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    rs = np.random.RandomState(7 * d + G + S + window)
    B, Hkv = 2, 2
    q = _t(rs, (B, S, Hkv * G, d), dev)
    k, v = _t(rs, (B, S, Hkv, d), dev), _t(rs, (B, S, Hkv, d), dev)
    do = _t(rs, (B, S, Hkv * G, d), dev)
    o, lse = ops.attention_lse(q, k, v, causal=causal, window=window)
    rt.reset_launches()
    got = ops.attention_bwd(q, k, v, o, lse, do, causal=causal,
                            window=window)
    again = ops.attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert rt.launch_counts()["flash_prefill_bwd"] == 2
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.equal(g, a), f"{name}: two calls differ"
        if S == 1 and name != "dv":
            assert torch.isfinite(g).all()
            big = float(g.float().abs().max())
            assert big <= BWD_REL_L2 * float(want[2].abs().max()), \
                f"{name}: {big} where it vanishes"
            continue
        err = _rel_l2(g, w)
        assert err < BWD_REL_L2, f"{name}: rel L2 {err}"
    # the same through autograd: attention routes to FlashAttention
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.attention(qg, kg, vg, causal=causal, window=window)
    out.backward(do)
    for name, t, g in zip(("dq", "dk", "dv"), (qg, kg, vg), got):
        assert torch.equal(t.grad, g), name


# run in a child process under a timeout: an ordering deadlock there is
# killed with it and fails the test instead of hanging the card
_MORE_TILES = """
import sys
import numpy as np
import torch
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
dk, dv, causal, window = (int(a) for a in sys.argv[1:])
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
tile = 128 if dk <= 128 else 64
S = rt.device_sms(0) * tile + 300
rs = np.random.RandomState(S)
t = lambda shape: torch.as_tensor(rs.standard_normal(shape),
                                  dtype=torch.float32,
                                  device=dev).to(torch.bfloat16)
q, do = t((1, S, 2, dk)), t((1, S, 2, dv))
k, v = t((1, S, 1, dk)), t((1, S, 1, dv))
o, lse = ops.attention_lse(q, k, v, causal=bool(causal), window=window)
got = ops.attention_bwd(q, k, v, o, lse, do, causal=bool(causal),
                        window=window)
again = ops.attention_bwd(q, k, v, o, lse, do, causal=bool(causal),
                          window=window)
torch.cuda.synchronize()
want = attention_bwd_ref(q, k, v, do, causal=bool(causal), window=window)
for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
    assert torch.equal(g, a), f"{name}: two calls differ"
    g, w = g.float(), w.float()
    assert torch.isfinite(g).all(), name
    err = float((g - w).norm() / w.norm().clamp_min(1e-30))
    assert err < 2.0 ** -6, f"{name}: rel L2 {err}"
print("ok", S)
"""


@pytest.mark.parametrize("dk,dv", [(64, 64), (256, 256), (192, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 1000)])
def test_backward_with_more_key_tiles_than_sms(dev, dk, dv, causal, window):
    """One (batch, kv head) with more key tiles than the card has SMs
    (128-key tiles at d 64, 64-key tiles at d 256 and (192, 128), where
    the heads are not split): its CTAs cannot all be resident at once, and
    each q tile's dQ is summed in their launch order, so a CTA may only
    wait on one launched before it. G 2; against the plain version as
    above, in a child process killed after 300 s."""
    import os
    import subprocess
    import sys
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    try:
        r = subprocess.run(
            [sys.executable, "-c", _MORE_TILES, str(dk), str(dv),
             str(int(causal)), str(window)], env=env, capture_output=True,
            text=True, timeout=300)
    except subprocess.TimeoutExpired:
        pytest.fail("the backward did not finish in 300 s: a CTA waits on "
                    "one that cannot run")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]


# (dk, dv, G, Sq, Sk, causal, window) past the square d 32 / 64 / 128 cases:
# d 256 (RecurrentGemma's 16 q heads on one kv head, windowed) and MLA's
# (192, 128) causal on wide_kernel's 64-key tiles and 64-row q tiles (32
# rows a warpgroup); FULL (neither mask) with Sq != Sk at every width, Sk
# off the 128- and 64-key tiles (keys past Sk masked)
NEW_CASES = [
    (256, 256, 16, 100, 100, True, 64), (256, 256, 16, 300, 300, True, 128),
    (256, 256, 1, 65, 65, True, 0), (256, 256, 2, 129, 129, False, 17),
    (256, 256, 4, 70, 130, False, 0), (256, 256, 16, 33, 33, True, 31),
    (192, 128, 1, 63, 63, True, 0), (192, 128, 1, 257, 257, True, 0),
    (192, 128, 2, 130, 130, True, 40), (192, 128, 1, 33, 100, False, 0),
    (64, 64, 1, 100, 300, False, 0), (64, 64, 2, 1, 129, False, 0),
    (64, 64, 1, 300, 65, False, 0), (32, 32, 4, 77, 200, False, 0),
    (128, 128, 1, 130, 257, False, 0), (64, 64, 1, 257, 257, False, 0),
]

# and at wide_kernel's 64-key and 64-row tile edges, both widths: S 63 / 64
# / 65 / 127 / 129 causal, windowed (with and without the causal mask) and
# FULL with Sq != Sk either way (the two already above left out)
NEW_CASES += [case for case in [
    (dk, dv, G, Sq, Sk, causal, window)
    for dk, dv in ((256, 256), (192, 128))
    for G, Sq, Sk, causal, window in (
        (1, 63, 63, True, 0), (2, 64, 64, True, 0), (1, 65, 65, True, 0),
        (4, 127, 127, True, 0), (1, 129, 129, True, 0),
        (2, 127, 127, True, 64), (1, 129, 129, True, 63),
        (2, 65, 65, False, 64), (1, 129, 129, False, 17),
        (2, 63, 129, False, 0), (1, 129, 64, False, 0),
        (1, 65, 127, False, 0))]
    if case not in NEW_CASES]


@pytest.mark.parametrize("dk,dv,G,Sq,Sk,causal,window", NEW_CASES)
def test_backward_at_the_new_contracts(dev, dk, dv, G, Sq, Sk, causal,
                                       window):
    """As ``test_backward_at_tile_edges``, at d 256, (192, 128) and FULL
    with Sq != Sk; the LSE form's o and lse against ``attention_lse_ref``
    (o within 2^-6 a row, lse within 1e-3) on the way."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref)
    rs = np.random.RandomState(dk + dv + G + Sq + 3 * Sk + window)
    B, Hkv = 2, 1 if G == 16 else 2
    q = _t(rs, (B, Sq, Hkv * G, dk), dev)
    k, v = _t(rs, (B, Sk, Hkv, dk), dev), _t(rs, (B, Sk, Hkv, dv), dev)
    do = _t(rs, (B, Sq, Hkv * G, dv), dev)
    rt.reset_launches()
    o, lse = ops.attention_lse(q, k, v, causal=causal, window=window)
    o_ref, lse_ref = attention_lse_ref(q, k, v, causal=causal,
                                       window=window)
    got = ops.attention_bwd(q, k, v, o, lse, do, causal=causal,
                            window=window)
    again = ops.attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    n = rt.launch_counts()
    assert n["flash_prefill[lse]"] == 1 and n["flash_prefill_bwd"] == 2
    assert lse.shape == (B, Hkv * G, Sq)
    assert float((lse - lse_ref).abs().max()) < 1e-3
    row_err = float(((o.float() - o_ref.float()).norm(dim=-1)
                     / o_ref.float().norm(dim=-1).clamp_min(1e-30)).max())
    assert row_err < BWD_REL_L2, row_err
    want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.equal(g, a), f"{name}: two calls differ"
        err = _rel_l2(g, w)
        assert err < BWD_REL_L2, f"{name}: rel L2 {err}"
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.attention(qg, kg, vg, causal=causal, window=window)
    out.backward(do)
    for name, t, g in zip(("dq", "dk", "dv"), (qg, kg, vg), got):
        assert torch.equal(t.grad, g), name
    assert torch.equal(out, o)


# (dk, dv, B, S, window): G 16 on one kv head, with (key tiles x batch)
# below a wave of the card's SMs, so the heads are split (S 300, 2000 at B
# 2: 5 and 32 key tiles), and at or above it (66 x 2 key tiles of S 128),
# where they are not
SPLIT_CASES = [(256, 256, 2, 300, 2048), (256, 256, 2, 2000, 1024),
               (256, 256, 66, 128, 0), (192, 128, 2, 300, 0),
               (192, 128, 66, 128, 100)]


@pytest.mark.parametrize("dk,dv,B,S,window", SPLIT_CASES)
def test_wide_backward_head_split(dev, dk, dv, B, S, window):
    """G 16 q heads on one kv head, causal: ``flash_prefill_bwd_split``
    splits them over CTAs where the grid leaves the card's SMs idle (each
    head group's dK / dV summed in group order) and keeps them together
    where it fills a wave; gradients as above either way, two calls equal
    bit for bit."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    split = rt.bind("flash_prefill_bwd", "flash_prefill_bwd_split",
                    [rt.I] * 7)(B, S, 16, 1, dk, dv,
                                rt.device_sms(dev.index or 0))
    assert (split > 1) == (B * -(-S // 64) < rt.device_sms(dev.index or 0))
    rs = np.random.RandomState(dk + B + S + window)
    q, do = _t(rs, (B, S, 16, dk), dev), _t(rs, (B, S, 16, dv), dev)
    k, v = _t(rs, (B, S, 1, dk), dev), _t(rs, (B, S, 1, dv), dev)
    o, lse = ops.attention_lse(q, k, v, causal=True, window=window)
    got = ops.attention_bwd(q, k, v, o, lse, do, causal=True, window=window)
    again = ops.attention_bwd(q, k, v, o, lse, do, causal=True,
                              window=window)
    torch.cuda.synchronize()
    want = attention_bwd_ref(q, k, v, do, causal=True, window=window)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(g, a), f"{name}: two calls differ"
        err = _rel_l2(g, w)
        assert err < BWD_REL_L2, f"{name}: rel L2 {err} (split {split})"


@pytest.mark.parametrize("dk,dv", [(64, 64), (256, 256), (192, 128)])
def test_full_masks_the_keys_past_sk(dev, dk, dv):
    """FULL at Sk 200 (off the 128- and 64-key tiles) with every score of
    a row far below 0 (q 32 and k -32 in the first 4 elements, standard
    normal in the rest: s about -4096 / sqrt dk), so lse is far below 0 and
    a zero key past Sk would weigh exp(-lse), past f32's range: unmasked,
    dq turns NaN. Its gradients are finite and match the plain version
    outside those 4 columns (there the common -32 of every key cancels in
    dq = sum ds k, and so does q's 32 in dk: bf16 rounding, no signal)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    rs = np.random.RandomState(dk)
    B, Sq, Sk, H = 1, 70, 200, 2
    q, k = _t(rs, (B, Sq, H, dk), dev), _t(rs, (B, Sk, H, dk), dev)
    q[..., :4], k[..., :4] = 32.0, -32.0
    v, do = _t(rs, (B, Sk, H, dv), dev), _t(rs, (B, Sq, H, dv), dev)
    o, lse = ops.attention_lse(q, k, v, causal=False)
    assert float(lse.max()) < -100.0
    got = ops.attention_bwd(q, k, v, o, lse, do, causal=False)
    want = attention_bwd_ref(q, k, v, do, causal=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        if name != "dv":
            g, w = g[..., 4:], w[..., 4:]
        err = _rel_l2(g, w)
        assert err < BWD_REL_L2, f"{name}: rel L2 {err}"


# the kernels' error where every key shares an offset, as a multiple of the
# error of the plain formulas at their bf16 rounding points
ROUNDING_RATIO = 1.25


@pytest.mark.parametrize("dk,dv", [(64, 64), (256, 256), (192, 128)])
def test_full_shared_key_offset_is_rounding(dev, dk, dv, capsys):
    """FULL at Sk 200 where every key shares an offset (q 4 and k -4 +
    0.25 N(0, 1) in every element). The offset cancels in dq = sum_j ds_ij
    k_j (sum_j ds_ij = 0) and q's in dk = sum_i ds_ij q_i, so ds's bf16
    rounding, scaled up by the offsets, dominates dq's and dk's error: the
    plain formulas at the kernels' bf16 rounding points
    (``attention_bwd_masked(..., rounded=True)``) read it too, above
    ``BWD_REL_L2``. Each of the kernel's dq, dk, dv, against the f32
    formulas, is held within ``ROUNDING_RATIO`` of theirs; both readings
    are printed."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_masked,
                                                         attention_mask)
    rs = np.random.RandomState(dk)
    B, Sq, Sk, H = 1, 70, 200, 2
    q = torch.full((B, Sq, H, dk), 4.0, dtype=torch.bfloat16, device=dev)
    k = torch.as_tensor(-4.0 + 0.25 * rs.standard_normal((B, Sk, H, dk)),
                        dtype=torch.float32, device=dev).to(torch.bfloat16)
    v, do = _t(rs, (B, Sk, H, dv), dev), _t(rs, (B, Sq, H, dv), dev)
    o, lse = ops.attention_lse(q, k, v, causal=False)
    got = ops.attention_bwd(q, k, v, o, lse, do, causal=False)
    mask = attention_mask(Sq, Sk, causal=False, device=dev)
    want = attention_bwd_masked(q, k, v, do, mask)
    rounded = attention_bwd_masked(q, k, v, do, mask, rounded=True)
    for name, g, r, w in zip(("dq", "dk", "dv"), got, rounded, want):
        err, floor = _rel_l2(g, w), _rel_l2(r, w)
        with capsys.disabled():
            print(f"\n({dk}, {dv}) {name}: the kernel {err:.4e}, the plain "
                  f"formulas at its rounding points {floor:.4e}")
        assert err <= ROUNDING_RATIO * floor, (name, err, floor)
