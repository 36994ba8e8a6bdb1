"""The serving engine's sequential prefill on the card: ``flash_prefill`` at
the shape the engine gives it (one prompt, B = 1, the expert's 32 heads of
128 at short, ragged lengths) against its plain version, and a
``ServingEngine(prefill_mode="sequential")`` over a 2-layer reduced expert
launching it once per layer per admitted request. Every test here carries
the ``gpu`` marker and skips, from inside a fixture, where no card is
present. Run them on an H100 with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_serve_modes_gpu.py

This file imports no JAX: the machine with the card has none.

Tolerance, as ``tests/test_torch_prefill_kernels_gpu.py``: two units in the
last place of the largest value (2^-7 relative, at least 2^-7 absolute),
and each query row's relative L2 error at most 2^-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import tree_bytes, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import get_model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import Request, ServingEngine

pytestmark = pytest.mark.gpu

ROW_REL_L2 = 2.0 ** -6
PAGED = ("decode_paged", "qkv_rope_paged", "oproj_ffn_swiglu")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_flash_prefill_at_one_short_prompt(dev):
    """B = 1, 32 heads of 128 on 32 kv heads, S in {1, 17, 64, 255}:
    what sequential prefill of a 64-256-token prompt launches."""
    for S in (1, 17, 64, 255):
        rs = np.random.RandomState(S)
        q, k, v = (torch.as_tensor(rs.standard_normal((1, S, 32, 128)),
                                   dtype=torch.float32,
                                   device=dev).to(torch.bfloat16)
                   for _ in range(3))
        rt.reset_launches()
        got = attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert rt.launch_counts()["flash_prefill"] == 1
        want = attention_ref(q, k, v, causal=True)
        err = float((got.float() - want.float()).abs().max())
        tol = 2.0 ** -7 * max(float(want.float().abs().max()), 1.0)
        assert got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        assert err <= tol, (S, err, tol)
        g, w = got.float(), want.float()
        row = float(((g - w).norm(dim=-1)
                     / w.norm(dim=-1).clamp_min(1e-30)).max())
        assert row <= ROW_REL_L2, (S, row)


def test_sequential_engine_launches_flash_prefill_per_layer_per_request(dev):
    cfg = dataclasses.replace(reduced(get_config("samba-coe-expert-7b")),
                              n_layers=2)
    m = get_model(cfg)
    trees = [tree_map(lambda t: t.to(torch.bfloat16),
                      m.init(torch.Generator(device=dev).manual_seed(i), dev))
             for i in range(2)]
    nbytes = tree_bytes(trees[0])
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 17, 33, 64, 9)]
    for mode in ("sequential", "packed"):
        reg = MetricsRegistry()
        coe = CompositionOfExperts(HashRouter(2), None, int(2.5 * nbytes),
                                   device=dev, registry=reg)
        for i, t in enumerate(trees):
            coe.register(ExpertHandle(f"e{i}", cfg, t))
        eng = ServingEngine(coe, cfg, max_len=128, n_slots=4, block_size=16,
                            prefill_mode=mode, device=dev, registry=reg)
        eng.warmup()
        rt.reset_launches()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=6,
                               expert=f"e{i % 2}"))
        done = eng.drain()
        torch.cuda.synchronize()
        n = rt.launch_counts()
        rounds = eng.stats.decode_rounds
        assert len(done) == len(prompts)
        assert eng.pool.check_invariants() == []
        assert eng.pool.stats.blocks_in_use == 0
        want = cfg.n_layers * len(prompts) if mode == "sequential" else 0
        assert n["flash_prefill"] == want, (mode, n)
        for name in PAGED:
            assert n[name] == cfg.n_layers * rounds, (mode, name, n)
        for name, c in n.items():
            if name not in PAGED and name != "flash_prefill":
                assert c == 0, (mode, name, c)
        for r in done:
            assert len(r.output) == 6
            assert ((r.output >= 0) & (r.output < cfg.vocab_size)).all()
        coe.cache.close()
