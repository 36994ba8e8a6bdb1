"""The kernel wrappers' fake branch, which a dry-run traces
(``launch.dryrun``): on fake tensors (``FakeTensor``) on the card, each
wrapper the step builders reach (``attention``, ``attention_lse``,
``attention_bwd``, ``lru_scan``, ``lru_scan_bwd``) checks its arguments,
returns empty outputs of the shapes and types the plain version returns
on the CPU, hands its cost function's work to ``runtime.traced`` and
builds, binds and counts nothing. The recorded work at the kernel table's
shapes is the bound column of PERF.md's rows 5, 5ᴸ, 5ᴮ, 5ᴰ, 5ᴮ‴, 8 and
8ᴮ. ``FlashAttention`` and ``LruScan`` run forward and backward on fake
tensors on the meta device (a torch built without CUDA has no device
guard for autograd on fake CUDA tensors; ``runtime.on_card`` takes fake
meta tensors as the card's)."""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.kernels.lru_scan.ref import lru_scan_bwd_ref, lru_scan_ref

BF = torch.bfloat16


@pytest.fixture
def recorded(monkeypatch):
    """The work each fake call records; binding a kernel fails the
    test."""
    def no_bind(*a, **k):
        raise AssertionError("a fake call bound a kernel")
    monkeypatch.setattr(rt, "bind", no_bind)
    monkeypatch.setattr(rt, "build", no_bind)
    calls = []
    before = rt.launch_counts()
    with rt.cost_hook(lambda name, f, b: calls.append((name, f, b))):
        yield calls
    assert rt.launch_counts() == before


def _fake(mode, shapes, dtype, device="cuda"):
    with mode:
        return [torch.empty(s, dtype=dtype, device=device) for s in shapes]


def _fake_like(mode, *tensors):
    with mode:
        return [torch.empty(t.shape, dtype=t.dtype, device="cuda")
                for t in tensors]


def _same(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, FakeTensor) and g.device.type == "cuda"
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


# (B, Sq, Sk, Hq, Hkv, dk, dv, causal, window): causal, windowed GQA, MLA's
# widths, FULL cross-attention
SMALL = [(2, 33, 33, 4, 2, 32, 32, True, 0),
         (1, 40, 40, 4, 1, 64, 64, True, 16),
         (2, 17, 17, 2, 2, 192, 128, True, 0),
         (2, 9, 21, 3, 3, 64, 64, False, 0)]


@pytest.mark.parametrize("case", SMALL)
def test_fake_attention_shapes_match_the_plain_version(case, recorded):
    B, Sq, Sk, Hq, Hkv, dk, dv, causal, window = case
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=g).to(BF) for s in (
        (B, Sq, Hq, dk), (B, Sk, Hkv, dk), (B, Sk, Hkv, dv), (B, Sq, Hq, dv)))
    mode = FakeTensorMode()
    fq, fk, fv, fdo = _fake_like(mode, q, k, v, do)
    kw = dict(causal=causal, window=window)
    with mode:
        o = ops.attention(fq, fk, fv, **kw)
        fo, flse = ops.attention_lse(fq, fk, fv, **kw)
        grads = ops.attention_bwd(fq, fk, fv, fo, flse, fdo, **kw)
    _same(o, attention_ref(q, k, v, **kw))
    _same((fo, flse), attention_lse_ref(q, k, v, **kw))
    assert [c[0] for c in recorded] == ["flash_prefill", "flash_prefill[lse]",
                                        "flash_prefill_bwd"]
    want = ops.attention_cost(B, Sq, Sk, Hq, Hkv, dk, dv, causal, window)
    assert recorded[0][1:] == tuple(want)
    assert recorded[1][1:] == (want.flops, want.bytes + 4 * B * Hq * Sq)
    assert recorded[2][1:] == tuple(ops.attention_bwd_cost(
        B, Sq, Sk, Hq, Hkv, dk, dv, causal, window))
    # the wrapper's plain backward on the CPU: dq, dk, dv as q, k, v
    _same(grads, ops.attention_bwd(q, k, v, *attention_lse_ref(q, k, v, **kw),
                                   do, **kw))


def test_fake_lru_scan_shapes_match_the_plain_version(recorded):
    g = torch.Generator().manual_seed(0)
    a, b, dh = (torch.rand((2, 19, 8), generator=g) for _ in range(3))
    mode = FakeTensorMode()
    fa, fb, fdh = _fake_like(mode, a, b, dh)
    with mode:
        h = lru_ops.lru_scan(fa, fb)
        grads = lru_ops.lru_scan_bwd(fa, h, fdh)
    _same(h, lru_scan_ref(a, b))
    _same(grads, lru_scan_bwd_ref(a, lru_scan_ref(a, b), dh))
    assert recorded == [("lru_scan", *lru_ops.lru_scan_cost(2, 19, 8)),
                        ("lru_scan_bwd", *lru_ops.lru_scan_bwd_cost(2, 19, 8))]


def test_fake_calls_keep_the_kernels_contract(recorded):
    mode = FakeTensorMode()
    q, k, v = _fake(mode, [(1, 8, 2, 48)] * 2 + [(1, 8, 2, 32)], BF)
    with mode, pytest.raises(ValueError, match="PREFILL_WIDTHS|kernel takes"):
        ops.attention(q, k, v)
    a, b = _fake(mode, [(1, 4, 8)] * 2, BF)
    with mode, pytest.raises(TypeError, match="f32"):
        lru_ops.lru_scan(a, b)
    assert recorded == []


def _mb(x):
    return round(x / 1e6, 1)


# PERF.md's kernel table: row -> (call, shape, the bound column's bytes in
# MB and flops as printed)
ROWS = {
    "5": ("attention", (8, 2048, 2048, 32, 32, 128, 128, True, 0),
          536.9, "2.750e+11"),
    "5ᴸ": ("attention_lse", (4, 2048, 2048, 32, 32, 128, 128, True, 0),
           269.5, "1.375e+11"),
    "5ᴮ": ("attention_bwd", (4, 2048, 2048, 32, 32, 128, 128, True, 0),
           537.9, "3.438e+11"),
    "5ᴰ": ("attention", (4, 2048, 2048, 16, 16, 192, 128, True, 0),
           167.8, "8.594e+10"),
    "5ᴮ‴": ("attention_bwd", (4, 2048, 2048, 16, 16, 192, 128, True, 0),
            336.1, "2.234e+11"),
    "8": ("lru_scan", (4, 3000, 4096), 589.8, "9.8e+07"),
    "8ᴮ": ("lru_scan_bwd", (4, 3000, 4096), 983.0, "1.5e+08"),
}


@pytest.mark.parametrize("row", list(ROWS))
def test_fake_call_records_the_kernel_tables_bound(row, recorded):
    call, shape, mb, flops = ROWS[row]
    mode = FakeTensorMode()
    if call.startswith("lru"):
        B, S, D = shape
        x = _fake(mode, [(B, S, D)] * 3, torch.float32)
        with mode:
            if call == "lru_scan":
                lru_ops.lru_scan(x[0], x[1])
            else:
                lru_ops.lru_scan_bwd(*x)
    else:
        B, Sq, Sk, Hq, Hkv, dk, dv, causal, window = shape
        q, k, v, o = _fake(mode, [(B, Sq, Hq, dk), (B, Sk, Hkv, dk),
                                  (B, Sk, Hkv, dv), (B, Sq, Hq, dv)], BF)
        with mode:
            if call == "attention":
                ops.attention(q, k, v, causal=causal, window=window)
            elif call == "attention_lse":
                ops.attention_lse(q, k, v, causal=causal, window=window)
            else:
                lse = torch.empty((B, Hq, Sq), device="cuda")
                ops.attention_bwd(q, k, v, o, lse, torch.empty_like(o),
                                  causal=causal, window=window)
    ((_, got_flops, got_bytes),) = recorded
    digits = len(flops.split("e")[0]) - 2
    assert (_mb(got_bytes), f"{got_flops:.{digits}e}") == (mb, flops), row


def test_autograd_through_the_fake_kernels(recorded):
    """``FlashAttention`` and ``LruScan`` on fake meta tensors that
    require grad: forward and backward each record their kernel once."""
    mode = FakeTensorMode()
    with mode:
        q, k, v = (torch.empty((2, 64, 4, 64), dtype=BF, device="meta",
                               requires_grad=True) for _ in range(3))
        a, b = (torch.empty((2, 64, 8), device="meta", requires_grad=True)
                for _ in range(2))
        o = ops.attention(q, k, v, causal=True)
        h = lru_ops.lru_scan(a, b)
        (o.float().sum() + h.sum()).backward()
        assert q.grad.shape == q.shape and a.grad.shape == a.shape
    assert sorted(c[0] for c in recorded) == sorted(
        ["flash_prefill[lse]", "flash_prefill_bwd", "lru_scan",
         "lru_scan_bwd"])
