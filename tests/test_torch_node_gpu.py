"""The node's tensor-parallel step and the expert tier on the card. Every
test carries the ``gpu`` marker and skips, from inside the test, where no
card is present. Run them on an H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_node_gpu.py

This file imports no JAX: the machine with the card has none.

Tolerances: a kernel against its plain version, two units in the last place
of the largest value (both sum in f32 and round to bf16 once); the fused TP
step's logits against the plain TP body's run in f32 on the same bf16
weights and pool, 1.8 % of the largest logit (``chip_smoke.py``'s
``LOGIT_TOL_REL`` for one decode step)."""
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


def _close(got, ref):
    err = float((got.float() - ref.float()).abs().max())
    tol = 2.0 ** -7 * max(float(ref.float().abs().max()), 1.0)
    assert torch.isfinite(got.float()).all()
    assert err <= tol, (err, tol)


def _t(rs, shape, dev, scale=1.0):
    return torch.as_tensor(rs.standard_normal(shape) * scale,
                           dtype=torch.float32, device=dev).to(torch.bfloat16)


def test_shard_shape_kernels_match_their_plain_versions(dev):
    """The three kernels of the fused TP body at one rank's shape of the 7B
    expert at TP 2: ``qkv_rope_paged`` at 16 q / 16 kv heads,
    ``decode_paged`` at 16 heads, ``ffn_swiglu(residual=False)`` at
    F 5504 (43 column groups of 128)."""
    from repro_torch.kernels.flash_attention.ops import decode_paged
    from repro_torch.kernels.flash_attention.ref import decode_paged_ref
    from repro_torch.kernels.fused_decode.ops import (ffn_swiglu,
                                                      qkv_rope_paged)
    from repro_torch.kernels.fused_decode.ref import (ffn_swiglu_ref,
                                                      qkv_rope_paged_ref,
                                                      rope_inv_freq)
    rs = np.random.RandomState(3)
    B, D, H, dh, F, block, maxb = 8, 4096, 16, 128, 5504, 16, 32
    x, scale = _t(rs, (B, D), dev), _t(rs, (D,), dev, 0.1) + 1
    wq, wk, wv = (_t(rs, (D, H, dh), dev, D ** -0.5) for _ in range(3))
    pos = torch.as_tensor([0, 14, 15, 16, 99, 254, 300, 511],
                          dtype=torch.int32, device=dev)
    inv = torch.as_tensor(rope_inv_freq(dh, 10000.0), device=dev)
    rt.reset_launches()
    got = qkv_rope_paged(x, scale, wq, wk, wv, pos)
    want = qkv_rope_paged_ref(x, scale, wq, wk, wv, pos, inv)
    for g, w in zip(got, want):
        _close(g, w)
    rows = B * maxb + 1
    kp, vp = _t(rs, (rows, block, H, dh), dev), _t(rs, (rows, block, H, dh),
                                                  dev)
    tables = torch.randperm(rows - 1, device=dev)[:B * maxb].reshape(
        B, maxb).to(torch.int32)
    len1 = pos + 1
    _close(decode_paged(got[0], kp, vp, tables, len1),
           decode_paged_ref(got[0], kp, vp, tables, len1))
    wg, wu = _t(rs, (D, F), dev, D ** -0.5), _t(rs, (D, F), dev, D ** -0.5)
    wd = _t(rs, (F, D), dev, F ** -0.5)
    _close(ffn_swiglu(x, scale, wg, wu, wd, residual=False),
           ffn_swiglu_ref(x, scale, wg, wu, wd, residual=False))
    n = rt.launch_counts()
    assert (n["qkv_rope_paged"], n["decode_paged"],
            n["ffn_swiglu[residual=False]"], n["ffn_swiglu"]) == (1, 1, 1, 0)


def _small_tp_runner(dev, backend):
    from repro_torch.configs import ModelConfig
    from repro_torch.models import get_model
    from repro_torch.node import TPPagedDecodeRunner
    from repro_torch.serving import PagedKVCache
    cfg = ModelConfig(name="tp-small", family="dense", n_layers=2,
                      d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
                      d_ff=768, vocab_size=1024)
    pool = PagedKVCache(40, 16, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                        scratch=True, device=dev)
    runner = TPPagedDecodeRunner(cfg, pool.scratch_index, (dev, dev),
                                 backend=backend(cfg))
    pool.shard_heads(2)
    gen = torch.Generator(device=dev).manual_seed(0)
    host = tree_map(lambda t: t.cpu(), get_model(cfg).init(gen, dev))
    return cfg, pool, runner, host


def test_fused_tp_step_matches_the_plain_tp_body(dev):
    """One g = 1 step of a TP = 2 group: the fused body (three kernels a
    rank and layer) against the plain TP body in f32 on the same pool;
    each kernel launched once a rank and layer, the partial FFN form."""
    from repro_torch.node.execution import tp_paged_extend
    from repro_torch.serving import FusedPagedBackend
    cfg, pool, runner, host = _small_tp_runner(dev, FusedPagedBackend)
    ranks = runner.place_params(host)
    torch.cuda.synchronize()
    rs = np.random.RandomState(1)
    pool.k.copy_(torch.as_tensor(rs.standard_normal(pool.k.shape) * 0.5,
                                 device=dev).to(pool.k.dtype))
    pool.v.copy_(torch.as_tensor(rs.standard_normal(pool.v.shape) * 0.5,
                                 device=dev).to(pool.v.dtype))
    B = 4
    tables = torch.as_tensor(rs.permutation(40)[:B * 8].reshape(B, 8),
                             dtype=torch.int32, device=dev)
    lengths = torch.as_tensor([0, 17, 64, 100], dtype=torch.int32,
                              device=dev)
    active = torch.tensor([True, True, False, True], device=dev)
    toks = torch.as_tensor(rs.randint(0, cfg.vocab_size, (B, 1)), device=dev)
    k0, v0 = pool.k.clone(), pool.v.clone()
    rt.reset_launches()
    lf, pk, pv = runner.extend(ranks, pool.k, pool.v, tables, lengths,
                               active, toks)
    torch.cuda.synchronize()
    n = rt.launch_counts()
    want = 2 * cfg.n_layers
    assert (n["qkv_rope_paged"], n["decode_paged"],
            n["ffn_swiglu[residual=False]"], n["ffn_swiglu"],
            n["oproj_ffn_swiglu"]) == (want, want, want, 0, 0)
    f32 = [tree_map(lambda t: t.float(), r) for r in ranks]
    lr, _, _ = tp_paged_extend(runner.layout, f32, k0.float(), v0.float(),
                               tables, lengths, active, toks,
                               runner.scratch_row)
    lf, lr = lf[active].float(), lr[active].float()
    assert torch.isfinite(lf).all()
    err = float((lf - lr).abs().max())
    assert err <= 0.018 * float(lr.abs().max()), err
    assert runner.gather_params(ranks)["layers"]["attn"]["wq"].equal(
        host["layers"]["attn"]["wq"].to(dev))


@pytest.mark.parametrize("eager", [False, True])
def test_mmap_store_feeds_the_cache_copy(dev, tmp_path, eager):
    """Lazy ``get`` (the map read by the host-to-device copy) and eager
    ``get`` both install the exact bytes; a dirty mutable entry evicted
    writes them back through the store."""
    from repro_torch.core import HBMWeightCache
    from repro_torch.store import MmapFileStore
    rs = np.random.RandomState(4)
    trees = {f"e{i}": {"w": _t(rs, (256, 384), dev).cpu(),
                       "b": torch.as_tensor(rs.standard_normal(77),
                                            dtype=torch.float32),
                       "n": [torch.arange(5, dtype=torch.int32)]}
             for i in range(2)}
    store = MmapFileStore(tmp_path / "tier", eager=eager)
    for name, t in trees.items():
        store.put(name, t)
    cache = HBMWeightCache(store.nbytes("e0"), store, dev)
    got = cache.activate("e0", read_only=False)
    assert got["w"].device.type == "cuda"
    for k in ("w", "b"):
        assert torch.equal(got[k].cpu(), trees["e0"][k])
    assert torch.equal(got["n"][0].cpu(), trees["e0"]["n"][0])
    got["b"].add_(1.0)
    cache.mark_dirty("e0")
    assert cache.prefetch("e1")
    cache.activate("e1")                           # evicts e0: write-back
    assert cache.stats.bytes_copied_back == store.nbytes("e0")
    assert torch.equal(store.get("e0")["b"], trees["e0"]["b"] + 1.0)
    cache.close()
