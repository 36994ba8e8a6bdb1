"""The tenancy and speculative paths on the card, over a reduced expert in
bf16 (the kernels take bf16 only). Every test here carries the ``gpu``
marker and skips, from inside a fixture, where no card is present. Run them
on an H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_tenancy_gpu.py

This file imports no JAX: the machine with the card has none.

  * A ``prefix_sharing=True`` engine: blocks that two decoding lanes and the
    prefix index share keep their bytes over every fused decode round; the
    suffix prefills (the g > 1 plain body) launch no kernel; each paged
    kernel launches once per layer per decode round.
  * ``SpeculativeDecode``: each paged kernel launches gamma x the draft's
    layers a round (the draft loop) and nothing else (the verify is the
    plain body); the draft prefills launch ``flash_prefill``; both pools
    end clean.
  * ``SpeculativeDecoder``: the dense kernels launch once per draft layer a
    draft step, ``flash_prefill`` once per layer of each prefill.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import tree_bytes, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.kernels import runtime as rt
from repro_torch.models import get_model
from repro_torch.serving import (Request, ServingEngine, SpeculativeDecode,
                                 SpeculativeDecoder)

pytestmark = pytest.mark.gpu

PAGED = ("decode_paged", "qkv_rope_paged", "oproj_ffn_swiglu")
DENSE = ("qkv_rope", "flash_decode", "ffn_swiglu")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tree(cfg, dev, seed):
    m = get_model(cfg)
    return tree_map(lambda t: t.to(torch.bfloat16),
                    m.init(torch.Generator(device=dev).manual_seed(seed),
                           dev))


def _engine(cfg, dev, tree, **kw):
    coe = CompositionOfExperts(HashRouter(1), None,
                               int(1.5 * tree_bytes(tree)), device=dev)
    coe.register(ExpertHandle("e0", cfg, tree))
    return coe, ServingEngine(coe, cfg, max_len=128, n_slots=4,
                              block_size=16, device=dev, **kw)


def _only(launches, want):
    for name, n in launches.items():
        assert n == want.get(name, 0), (name, n, want)


def test_shared_blocks_keep_their_bytes_over_fused_decode(dev):
    cfg = dataclasses.replace(reduced(get_config("samba-coe-expert-7b")),
                              n_layers=2)
    coe, eng = _engine(cfg, dev, _tree(cfg, dev, 0), prefix_sharing=True)
    rs = np.random.RandomState(0)
    base = rs.randint(0, cfg.vocab_size, (40,)).astype(np.int32)
    eng.submit(Request(rid=0, tokens=base, max_new_tokens=2, expert="e0"))
    eng.drain()                        # indexes two full blocks of 16
    shared = sorted(e.block for e in eng.prefix_index._entries.values())
    assert len(shared) == 2
    before = [(eng.pool.k[:, b].clone(), eng.pool.v[:, b].clone())
              for b in shared]
    suffix_launches = []
    real = eng._prefill_suffix

    def counted(*a, **k):
        torch.cuda.synchronize()
        n0 = rt.launch_counts()
        real(*a, **k)
        torch.cuda.synchronize()
        n1 = rt.launch_counts()
        suffix_launches.append({k: n1[k] - n0[k] for k in n1})

    eng._prefill_suffix = counted
    for rid in (1, 2):
        tail = rs.randint(0, cfg.vocab_size, (3 + 4 * rid,)).astype(np.int32)
        eng.submit(Request(rid=rid, tokens=np.concatenate([base[:36], tail]),
                           max_new_tokens=12, expert="e0"))
    rt.reset_launches()
    rounds0, most_refs = eng.stats.decode_rounds, 0
    while eng.has_work:
        eng.step()
        torch.cuda.synchronize()
        most_refs = max(most_refs, min(eng.pool.refcount(b) for b in shared))
        for b, (k, v) in zip(shared, before):
            assert torch.equal(eng.pool.k[:, b], k), b
            assert torch.equal(eng.pool.v[:, b], v), b
    launches = rt.launch_counts()
    assert most_refs >= 3                # the index and both lanes
    assert eng.stats.prefix_hit_tokens == 2 * 32
    assert suffix_launches and all(not any(d.values())
                                   for d in suffix_launches)
    _only(launches, {k: cfg.n_layers * (eng.stats.decode_rounds - rounds0)
                     for k in PAGED})
    eng.release_shared()
    assert eng.pool.stats.blocks_in_use == 0
    assert eng.pool.check_invariants() == []
    coe.cache.close()


def test_speculative_drain_launch_counts(dev):
    cfg = dataclasses.replace(reduced(get_config("samba-coe-expert-7b")),
                              n_layers=4)
    dcfg = dataclasses.replace(cfg, n_layers=2)
    gamma = 3
    spec = SpeculativeDecode(dcfg, _tree(dcfg, dev, 7), gamma=gamma)
    coe, eng = _engine(cfg, dev, _tree(cfg, dev, 0), policy=spec)
    rs = np.random.RandomState(1)
    n_req = 5
    for i in range(n_req):
        eng.submit(Request(rid=i, tokens=rs.randint(
            0, cfg.vocab_size, (6 + 9 * i,)).astype(np.int32),
            max_new_tokens=10, expert="e0"))
    rt.reset_launches()
    done = eng.drain()
    torch.cuda.synchronize()
    rounds = eng.stats.decode_rounds
    want = {k: gamma * dcfg.n_layers * rounds for k in PAGED}
    want["flash_prefill"] = dcfg.n_layers * n_req    # the draft's prefills
    _only(rt.launch_counts(), want)
    assert spec.stats.target_calls == rounds
    assert spec.stats.draft_calls == gamma * rounds
    assert len(done) == n_req
    for r in done:
        assert len(r.output) == 10
        assert ((r.output >= 0) & (r.output < cfg.vocab_size)).all()
    for pool in (eng.pool, spec.d_pool):
        assert pool.stats.blocks_in_use == 0
        assert pool.check_invariants() == []
    coe.cache.close()


def test_standalone_decoder_launch_counts(dev):
    cfg = dataclasses.replace(reduced(get_config("samba-coe-expert-7b")),
                              n_layers=4)
    dcfg = dataclasses.replace(cfg, n_layers=2)
    t_tree, d_tree = _tree(cfg, dev, 0), _tree(dcfg, dev, 7)
    prompt = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (1, 24)).astype(np.int32)
    sd = SpeculativeDecoder(cfg, dcfg, gamma=4)
    rt.reset_launches()
    out = sd.generate(t_tree, d_tree, prompt, 12)
    torch.cuda.synchronize()
    want = {k: dcfg.n_layers * sd.stats.draft_calls for k in DENSE}
    want["flash_prefill"] = cfg.n_layers + dcfg.n_layers
    _only(rt.launch_counts(), want)
    assert out.shape == (1, 12)
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
