"""The dense-family variants through the port's serving paths against the
JAX package, on the CPU, at ``reduced(...)`` size, on the same f32 experts
(JAX's init through numpy, bias and norm leaves redrawn from a seed so that
their branches carry weight):

  * engine drains on the plain paged body (``XlaPagedBackend``; JAX's
    ``backend="xla"``), f32 KV, in both prefill modes: greedy streams
    identical for every variant;
  * granite-8b on the default fused backend (the kernels' plain versions
    here) equal to JAX's drain; ``FusedPagedBackend`` and an engine left to
    its default refuse the other four, as JAX's fused backend does: no code
    path picks the plain body by itself;
  * the node's TP 2 paged extend (plain, and fused for granite) on
    ``pad_for_tp(reduced(...), 2)`` against JAX's single-device
    ``xla_paged_extend``: logits within 1e-4 of the largest, the pool
    within 1e-5;
  * speculative decoding with a draft the kernels refuse: the engine
    policy under the plain backend and the standalone decoder with
    ``draft_kernels=False`` against JAX's;
  * ``launch/serve.py --backend xla`` drains a variant, ``--backend
    fused`` refuses it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import pad_for_tp as jax_pad_for_tp
from repro.configs import reduced as jax_reduced
from repro.core import CompositionOfExperts as JaxCoE
from repro.core import ExpertHandle as JaxHandle
from repro.core import HashRouter as JaxHashRouter
from repro.models import get_model as jax_get_model
from repro.models import transformer as JT
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import SpeculativeDecode as JaxSpecDecode
from repro.serving import backends as JB
from repro.serving.speculative import SpeculativeDecoder as JaxSpecDecoder
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config, pad_for_tp, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.models import transformer as T
from repro_torch.node import TPPagedDecodeRunner, ensure_emulated_sockets
from repro_torch.serving import (FusedPagedBackend, Request, ServingEngine,
                                 SpeculativeDecode, SpeculativeDecoder,
                                 XlaPagedBackend)

ARCHS = ("granite-8b", "qwen2.5-32b", "chatglm3-6b", "starcoder2-3b",
         "qwen2-vl-2b")
REFUSED = ARCHS[1:]
ENGINE = dict(max_len=40, n_slots=3, block_size=8)
LOGIT_TOL_REL = 1e-4
POOL_ATOL = 1e-5
BIAS_LEAVES = {"bq", "bk", "bv", "bo", "bi", "bi_gate", "bi_up", "bias"}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _tree(jcfg, seed):
    """JAX's f32 init of ``jcfg`` with the bias and norm leaves redrawn."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        a = np.asarray(a, np.float32)
        key = str(path[-1].key)
        if key in BIAS_LEAVES:
            return (0.1 * rs.standard_normal(a.shape)).astype(np.float32)
        if key == "scale":
            return (1 + 0.1 * rs.standard_normal(a.shape)).astype(np.float32)
        return a
    p = jax_get_model(jcfg).init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map_with_path(draw, p)


@pytest.fixture(scope="module")
def experts():
    """Per arch: (JAX cfg, port cfg, two expert trees, bytes of one)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg, cfg = _cfgs(arch)
        trees = [_tree(jcfg, 10 * i + e) for e in range(2)]
        out[arch] = (jcfg, cfg, trees,
                     sum(a.nbytes for a in jax.tree.leaves(trees[0])))
    return out


def _requests(cls, vocab):
    rs = np.random.RandomState(7)
    return [cls(rid=i, tokens=rs.randint(0, vocab, (5 + 4 * (i % 3),))
                .astype(np.int32), max_new_tokens=3 + i % 3,
                expert=f"e{i % 2}") for i in range(5)]


def _jax_drain(ex, policy=None, **kw):
    jcfg, _, trees, nbytes = ex
    coe = JaxCoE(JaxHashRouter(2), None, int(2.5 * nbytes))
    for i, t in enumerate(trees):
        coe.register(JaxHandle(f"e{i}", jcfg, t))
    eng = JaxEngine(coe, jcfg, backend="xla", kv_dtype=jnp.float32,
                    policy=policy, **ENGINE, **kw)
    for r in _requests(JaxRequest, jcfg.vocab_size):
        eng.submit(r)
    out = {r.rid: r.output for r in eng.drain()}
    coe.cache.close()
    return out


def _port_drain(ex, backend, policy=None, **kw):
    _, cfg, trees, nbytes = ex
    coe = CompositionOfExperts(HashRouter(2), None, int(2.5 * nbytes),
                               device="cpu")
    for i, t in enumerate(trees):
        coe.register(ExpertHandle(f"e{i}", cfg, to_torch(t)))
    eng = ServingEngine(coe, cfg, backend=backend, kv_dtype=torch.float32,
                        device="cpu", policy=policy, **ENGINE, **kw)
    for r in _requests(Request, cfg.vocab_size):
        eng.submit(r)
    out = {r.rid: r.output for r in eng.drain()}
    assert eng.pool.stats.blocks_in_use == 0
    assert eng.pool.check_invariants() == []
    coe.cache.close()
    return out, eng


def _same(a, b, label):
    assert a.keys() == b.keys(), label
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid],
                                      err_msg=f"{label} request {rid}")


@pytest.mark.parametrize("prefill_mode", ["packed", "sequential"])
def test_plain_drains_match_jax(experts, prefill_mode):
    for arch in ARCHS:
        ex = experts[arch]
        want = _jax_drain(ex, prefill_mode=prefill_mode)
        got, eng = _port_drain(ex, XlaPagedBackend(ex[1]),
                               prefill_mode=prefill_mode)
        assert eng.runner.backend_name == "xla"
        _same(got, want, f"{arch} {prefill_mode}")


def test_granite_fused_drain_and_the_refusals(experts):
    ex = experts["granite-8b"]
    got, eng = _port_drain(ex, None)
    assert eng.runner.backend_name == "fused"
    _same(got, _jax_drain(ex), "granite-8b fused")
    for arch in REFUSED:
        jcfg, cfg, trees, nbytes = experts[arch]
        with pytest.raises(ValueError, match="backend='xla'"):
            JB.FusedPagedBackend(jcfg, 0)
        with pytest.raises(ValueError, match="XlaPagedBackend"):
            FusedPagedBackend(cfg)
        coe = CompositionOfExperts(HashRouter(2), None, int(2.5 * nbytes),
                                   device="cpu")
        with pytest.raises(ValueError, match="dense RMSNorm/SwiGLU"):
            ServingEngine(coe, cfg, device="cpu", **ENGINE)


def _state(cfg, g, seed, n_blocks=12, block=4, maxb=4):
    rs = np.random.RandomState(seed)
    shape = (cfg.n_layers, n_blocks + 1, block, cfg.n_kv_heads,
             cfg.head_dim)
    pk = rs.standard_normal(shape).astype(np.float32)
    pv = rs.standard_normal(shape).astype(np.float32)
    lengths = np.asarray([3, 5, 6, 0], np.int32)
    reserved = [-(-(3 + g) // block), 2, -(-(6 + g) // block),
                -(-g // block)]
    perm = rs.permutation(n_blocks)
    tables = np.full((4, maxb), n_blocks, np.int32)
    at = 0
    for i, n in enumerate(reserved):
        tables[i, :n] = perm[at:at + n]
        at += n
    active = np.asarray([True, False, True, True])
    tokens = rs.randint(0, cfg.vocab_size, (4, g)).astype(np.int32)
    return pk, pv, tables, lengths, active, tokens, n_blocks


def _sharded_pool(x, tp, kv_sharded):
    t = torch.tensor(x)
    if not kv_sharded:
        return t
    L, rows, blk, H, dh = t.shape
    return t.reshape(L, rows, blk, tp, H // tp, dh).permute(
        3, 0, 1, 2, 4, 5).contiguous().permute(1, 2, 3, 0, 4, 5)


def test_tp2_extend_matches_single_device():
    """As JAX's ``tests/test_distributed.py`` runs granite-8b padded for
    TP 2; starcoder2 and qwen2-vl add every bias, the LayerNorm, the GELU
    MLP, m-RoPE and the tied head (vocab-sharded)."""
    tp = 2
    for arch, g, backend in (("granite-8b", 1, FusedPagedBackend),
                             ("granite-8b", 3, XlaPagedBackend),
                             ("starcoder2-3b", 1, XlaPagedBackend),
                             ("starcoder2-3b", 3, XlaPagedBackend),
                             ("qwen2-vl-2b", 1, XlaPagedBackend)):
        jcfg, cfg = _cfgs(arch, n_layers=2)
        jcfg, cfg = jax_pad_for_tp(jcfg, tp), pad_for_tp(cfg, tp)
        params = _tree(jcfg, g)
        pk, pv, tables, lengths, active, tokens, scratch = _state(
            cfg, g, seed=g)
        jl, jk, jv = (np.asarray(x) for x in JB.xla_paged_extend(
            jcfg, params, jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(active),
            jnp.asarray(tokens), scratch))
        runner = TPPagedDecodeRunner(cfg, scratch,
                                     ensure_emulated_sockets(tp, "cpu"),
                                     backend=backend(cfg))
        assert runner.kv_sharded and runner.vocab_sharded
        ranks = runner.place_params(to_torch(params))
        if cfg.tie_embeddings:
            assert "lm_head" not in ranks[0]
            assert ranks[0]["embed"]["tok"].shape[0] == cfg.vocab_size // tp
        k6 = _sharded_pool(pk, tp, True)
        v6 = _sharded_pool(pv, tp, True)
        logits, k, v = runner.extend(
            ranks, k6, v6, torch.as_tensor(tables), torch.as_tensor(lengths),
            torch.as_tensor(active), torch.as_tensor(tokens).long())
        label = f"{arch} g={g} {backend.__name__}"
        tol = LOGIT_TOL_REL * float(np.abs(jl[active]).max())
        np.testing.assert_allclose(logits.numpy()[active], jl[active],
                                   atol=tol, rtol=0, err_msg=label)
        k, v = (t.reshape(pk.shape).numpy() for t in (k, v))
        np.testing.assert_allclose(k[:, :scratch], jk[:, :scratch],
                                   atol=POOL_ATOL, rtol=0, err_msg=label)
        np.testing.assert_allclose(v[:, :scratch], jv[:, :scratch],
                                   atol=POOL_ATOL, rtol=0, err_msg=label)


def test_speculative_with_a_plain_draft_matches_jax(experts, monkeypatch):
    """qwen2.5 (QKV biases) behind the engine's policy, 2-layer draft, the
    plain backend (the draft inherits it); starcoder2 (every bias, the
    LayerNorm, GELU, the tied head) behind the standalone decoder, whose
    draft the kernels refuse unless ``draft_kernels=False``. The standalone
    decoders run on f32 dense caches in both packages (JAX's is bf16
    whatever the weights, so both ``cache_spec``s are patched here, as
    ``test_torch_speculative.py`` does)."""
    ex = experts["qwen2.5-32b"]
    jd, d = _cfgs("qwen2.5-32b", n_layers=2)
    draft = _tree(jd, 99)
    jspec = JaxSpecDecode(jd, draft, gamma=3)
    want = _jax_drain(ex, policy=jspec)
    spec = SpeculativeDecode(d, to_torch(draft), gamma=3)
    got, eng = _port_drain(ex, XlaPagedBackend(ex[1]), policy=spec)
    assert spec.d_runner.backend_name == "xla"
    _same(got, want, "qwen2.5 speculative")
    assert dataclasses.asdict(spec.stats) == dataclasses.asdict(jspec.stats)
    assert spec.d_pool.stats.blocks_in_use == 0

    jspec_fn, spec_fn = JT.cache_spec, T.cache_spec
    monkeypatch.setattr(JT, "cache_spec", lambda *a: jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), jspec_fn(*a)))
    monkeypatch.setattr(T, "cache_spec", lambda *a: {
        k: (sh, torch.float32) for k, (sh, _) in spec_fn(*a).items()})
    jcfg, cfg, trees, _ = experts["starcoder2-3b"]
    jd, d = _cfgs("starcoder2-3b", n_layers=2, d_ff=128)
    draft = _tree(jd, 98)
    with pytest.raises(ValueError, match="draft_kernels=False"):
        SpeculativeDecoder(cfg, d)
    prompt = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jsd = JaxSpecDecoder(jcfg, jd, gamma=3)
    want = jsd.generate(trees[0], draft, prompt, 8)
    sd = SpeculativeDecoder(cfg, d, gamma=3, draft_kernels=False)
    got = sd.generate(to_torch(trees[0]), to_torch(draft), prompt, 8)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(sd.stats) == dataclasses.asdict(jsd.stats)


def test_launcher_backend_flag(capsys):
    from repro_torch.launch import serve
    args = ["--arch", "chatglm3-6b", "--device", "cpu", "--reduced",
            "--prompt-len", "8", "20", "--max-len", "64", "--requests", "6",
            "--new-tokens", "4", "--n-experts", "2"]
    engine, done = serve.main(args + ["--backend", "xla"])
    assert len(done) == 6 and engine.runner.backend_name == "xla"
    assert all(len(r.output) == 4 for r in done)
    assert "leaked=0" in capsys.readouterr().out
    with pytest.raises(ValueError, match="--backend xla"):
        serve.main(args)
