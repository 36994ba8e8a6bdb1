"""The MoE family (``reduced(mixtral-8x7b)``: 4 experts, top-2, ``moe_d_ff``
64) through the port's serving paths against the JAX package, on the CPU,
on the same f32 experts (JAX's init through numpy):

  * engine drains on the plain paged body (``XlaPagedBackend``; JAX's
    ``backend="xla"``), window 0 (both packages' paged runners refuse a
    window), the default ``capacity_factor`` 1.25, f32 KV, in both prefill
    modes: greedy streams identical. A step over 3 slots holds C = 2
    assignments an expert, so the drains drop assignments (counted here);
  * ``xla_paged_extend`` at g 1 and g 3 against JAX's on the same pool
    state (an inactive lane, a short table): logits within 1e-4 of the
    largest, the pool within 1e-5, as ``test_torch_variants_serving.py``
    holds the dense variants;
  * the standalone ``SpeculativeDecoder`` with an MoE target (window 32)
    and a 2-layer MoE draft on f32 dense caches (``cache_spec`` patched in
    both packages, as ``test_torch_speculative.py`` does): tokens and
    stats equal to JAX's; the draft needs ``draft_kernels=False``. A
    verify that would wrap the window ring is refused, where JAX's clamps
    its write (shown here);
  * the refusals JAX makes: the fused backend (MoE FFN), a windowed or
    ``first_dense_layers`` paged / packed runner, TP 2, and ``launch/
    serve.py --arch mixtral-8x7b`` (its 4096-position window); the port's
    default engine is the fused one, so it refuses MoE too;
  * the mmap and int8 stores round-trip JAX's bf16 MoE tree (3-D expert
    leaves, the f32 router) byte for byte against JAX's stores."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import CompositionOfExperts as JaxCoE
from repro.core import ExpertHandle as JaxHandle
from repro.core import HashRouter as JaxHashRouter
from repro.models import get_model as jax_get_model
from repro.models import transformer as JT
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import backends as JB
from repro.serving import prefill as JP
from repro.serving import speculative as JS
from repro.store import Int8BlockQuantizedStore as JaxInt8
from repro.store import MmapFileStore as JaxMmap
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import get_config, pad_for_tp, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.node import TPPagedDecodeRunner, ensure_emulated_sockets
from repro_torch.serving import (FusedPagedBackend, PackedPrefillRunner,
                                 PagedDecodeRunner, Request, ServingEngine,
                                 SpeculativeDecoder, XlaPagedBackend)
from repro_torch.serving import speculative as S
from repro_torch.store import Int8BlockQuantizedStore, MmapFileStore

ARCH = "mixtral-8x7b"
ENGINE = dict(max_len=40, n_slots=3, block_size=8)
LOGIT_TOL_REL = 1e-4
POOL_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(**kw):
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **kw),
            dataclasses.replace(reduced(get_config(ARCH)), **kw))


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def experts():
    """(JAX cfg, port cfg, two f32 expert trees, bytes of one), window 0."""
    jcfg, cfg = _cfgs(sliding_window=0)
    trees = [_f32(jax_get_model(jcfg).init(jax.random.PRNGKey(40 + e)))
             for e in range(2)]
    return jcfg, cfg, trees, sum(a.nbytes for a in jax.tree.leaves(trees[0]))


def _requests(cls, vocab):
    rs = np.random.RandomState(7)
    return [cls(rid=i, tokens=rs.randint(0, vocab, (5 + 4 * (i % 3),))
                .astype(np.int32), max_new_tokens=3 + i % 3,
                expert=f"e{i % 2}") for i in range(5)]


def _jax_drain(ex, **kw):
    jcfg, _, trees, nbytes = ex
    coe = JaxCoE(JaxHashRouter(2), None, int(2.5 * nbytes))
    for i, t in enumerate(trees):
        coe.register(JaxHandle(f"e{i}", jcfg, t))
    eng = JaxEngine(coe, jcfg, backend="xla", kv_dtype=jnp.float32,
                    **ENGINE, **kw)
    for r in _requests(JaxRequest, jcfg.vocab_size):
        eng.submit(r)
    out = {r.rid: r.output for r in eng.drain()}
    coe.cache.close()
    return out


def _port_drain(ex, **kw):
    _, cfg, trees, nbytes = ex
    coe = CompositionOfExperts(HashRouter(2), None, int(2.5 * nbytes),
                               device="cpu")
    for i, t in enumerate(trees):
        coe.register(ExpertHandle(f"e{i}", cfg, to_torch(t)))
    eng = ServingEngine(coe, cfg, backend=XlaPagedBackend(cfg),
                        kv_dtype=torch.float32, device="cpu", **ENGINE, **kw)
    for r in _requests(Request, cfg.vocab_size):
        eng.submit(r)
    out = {r.rid: r.output for r in eng.drain()}
    assert eng.pool.stats.blocks_in_use == 0
    assert eng.pool.check_invariants() == []
    coe.cache.close()
    return out, eng


@pytest.mark.parametrize("prefill_mode", ["packed", "sequential"])
def test_plain_drains_match_jax(experts, prefill_mode, monkeypatch):
    want = _jax_drain(experts, prefill_mode=prefill_mode)
    cfg = experts[1]
    route, seen = L.moe_route, []

    def counting(c, router, xt):
        out = route(c, router, xt)
        n = torch.bincount(out[2].reshape(-1), minlength=c.n_experts)
        seen.append(int((n - L.moe_capacity(c, xt.shape[0]))
                        .clamp_min(0).sum()))
        return out
    monkeypatch.setattr(L, "moe_route", counting)
    got, eng = _port_drain(experts, prefill_mode=prefill_mode)
    assert eng.runner.backend_name == "xla"
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"{prefill_mode} {rid}")
    assert L.moe_capacity(cfg, ENGINE["n_slots"]) == 2
    assert sum(seen) > 0, "no assignment was dropped"


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


@pytest.mark.parametrize("g", [1, 3])
def test_paged_extend_matches_jax(experts, g):
    """T = 4 lanes x g tokens, the inactive lane's token-0 garbage
    included, as both engines feed it: C = 3 (g 1) and 8 (g 3)."""
    jcfg, cfg, trees, _ = experts
    params = trees[0]
    pk, pv, tables, lengths, active, tokens, scratch = _state(cfg, g, g)
    jl, jk, jv = (np.asarray(x) for x in JB.xla_paged_extend(
        jcfg, params, jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(active), jnp.asarray(tokens),
        scratch))
    logits, k, v = XlaPagedBackend(cfg).extend(
        to_torch(params), torch.tensor(pk), torch.tensor(pv),
        torch.as_tensor(tables), torch.as_tensor(lengths),
        torch.as_tensor(active), torch.as_tensor(tokens).long(), scratch)
    tol = LOGIT_TOL_REL * float(np.abs(jl[active]).max())
    np.testing.assert_allclose(logits.numpy()[active], jl[active], atol=tol,
                               rtol=0)
    np.testing.assert_allclose(k.numpy()[:, :scratch], jk[:, :scratch],
                               atol=POOL_ATOL, rtol=0)
    np.testing.assert_allclose(v.numpy()[:, :scratch], jv[:, :scratch],
                               atol=POOL_ATOL, rtol=0)


def _cache_f32(monkeypatch):
    jspec, spec = JT.cache_spec, T.cache_spec
    monkeypatch.setattr(JT, "cache_spec", lambda *a: jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), jspec(*a)))
    monkeypatch.setattr(T, "cache_spec", lambda *a: {
        k: (sh, torch.float32) for k, (sh, _) in spec(*a).items()})


def test_speculative_decoder_matches_jax(monkeypatch):
    """Target: the windowed reduced Mixtral (W 32; 12 + 8 + gamma 3 + 2
    = 25 positions, inside the ring); draft: 2 MoE layers. Then a verify
    past the ring's wrap: the port refuses it, JAX's clamps its write onto
    the ring's last g entries instead of wrapping to entry 0."""
    _cache_f32(monkeypatch)
    jcfg, cfg = _cfgs()
    jd, d = _cfgs(n_layers=2)
    target = _f32(jax_get_model(jcfg).init(jax.random.PRNGKey(50)))
    draft = _f32(jax_get_model(jd).init(jax.random.PRNGKey(51)))
    with pytest.raises(ValueError, match="draft_kernels=False"):
        SpeculativeDecoder(cfg, d)
    prompt = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jsd = JS.SpeculativeDecoder(jcfg, jd, gamma=3)
    want = jsd.generate(target, draft, prompt, 8)
    sd = SpeculativeDecoder(cfg, d, gamma=3, draft_kernels=False)
    got = sd.generate(to_torch(target), to_torch(draft), prompt, 8)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(sd.stats) == dataclasses.asdict(jsd.stats)

    # a wrapped ring: prefill 40 tokens into W 32 (position p at p % 32),
    # then a verify of g 3 at position 62 (ring entries 30, 31, 0)
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, 40)).astype(np.int32)
    _, jc = JT.prefill(jcfg, target, jnp.asarray(toks), 64)
    _, c = T.prefill(cfg, to_torch(target), torch.as_tensor(toks).long(), 64)
    prop = np.asarray([[5, 6, 7]], np.int32)
    with pytest.raises(ValueError, match="wrap"):
        S.extend_step(cfg, to_torch(target), c, torch.as_tensor(prop), 62)
    before = np.asarray(jc["k"])
    _, jc2 = JS.extend_step(jcfg, target, jc, jnp.asarray(prop), 62)
    changed = np.nonzero(np.abs(np.asarray(jc2["k"]) - before)
                         .max(axis=(0, 1, 3, 4)))[0]
    assert changed.tolist() == [29, 30, 31]       # clamped, not 30, 31, 0


def test_refusals_match_jax(experts, capsys):
    jcfg, cfg, trees, nbytes = experts
    # the fused kernels compute no MoE FFN
    with pytest.raises(ValueError, match="MoE FFN"):
        JB.FusedPagedBackend(jcfg, 0)
    with pytest.raises(ValueError, match="MoE FFN"):
        FusedPagedBackend(cfg)
    coe = CompositionOfExperts(HashRouter(2), None, int(2.5 * nbytes),
                               device="cpu")
    with pytest.raises(ValueError, match="MoE FFN"):
        ServingEngine(coe, cfg, device="cpu", **ENGINE)
    # windows and DeepSeek's dense head layers, in both runners
    for kw, msg in ((dict(sliding_window=32), "sliding windows"),
                    (dict(first_dense_layers=1), "first_dense_layers")):
        jc, c = (dataclasses.replace(x, **kw) for x in (jcfg, cfg))
        for make_j, make_p in (
                (lambda: JB.PagedDecodeRunner(jc, 0),
                 lambda: PagedDecodeRunner(c, 0, XlaPagedBackend(c))),
                (lambda: JP.PackedPrefillRunner(jc, buckets=(16, 32)),
                 lambda: PackedPrefillRunner(c, buckets=(16, 32)))):
            with pytest.raises(ValueError, match=msg):
                make_j()
            with pytest.raises(ValueError, match=msg):
                make_p()
    # a TP group computes no MoE FFN (JAX: the same words, node/execution)
    tp = pad_for_tp(cfg, 2)
    with pytest.raises(ValueError, match="TP paged extend supports dense "
                                         "FFN only"):
        TPPagedDecodeRunner(tp, 0, ensure_emulated_sockets(2, "cpu"),
                            backend=XlaPagedBackend(tp))
    assert len(TPPagedDecodeRunner(cfg, 0, ensure_emulated_sockets(1, "cpu"),
                                   backend=XlaPagedBackend(cfg))
               .place_params(to_torch(trees[0]))) == 1
    # launch/serve.py: Mixtral's window, on either backend
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    common = ["--arch", ARCH, "--reduced", "--n-experts", "2",
              "--requests", "2", "--new-tokens", "2"]
    with pytest.raises(ValueError, match="sliding windows"):
        jserve.main(common + ["--prompt-len", "8"])
    for backend in ("fused", "xla"):
        with pytest.raises(ValueError, match="sliding windows"):
            serve.main(common + ["--device", "cpu", "--prompt-len", "8",
                                 "16", "--max-len", "32", "--backend",
                                 backend])
    capsys.readouterr()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def test_stores_round_trip_the_moe_tree(tmp_path):
    """JAX's bf16 init of the reduced Mixtral (and a shared expert): the
    mmap files byte-identical and each package reading the other's; the
    int8 store's codes, scales and dequantized leaves identical."""
    jcfg, cfg = _cfgs(n_shared_experts=1)
    tree = jax.tree.map(np.asarray,
                        jax_get_model(jcfg).init(jax.random.PRNGKey(60)))
    leaves = _flat(tree)
    assert leaves["layers/mlp/router"].dtype == np.float32
    assert leaves["layers/mlp/experts/wi_gate"].shape == (4, 4, 128, 64)
    js, ps = JaxMmap(tmp_path / "jax"), MmapFileStore(tmp_path / "port")
    js.put("m", tree)
    ps.put("m", to_torch(tree))
    for ext in (".bin", ".json"):
        assert ((tmp_path / "port" / ("m" + ext)).read_bytes()
                == (tmp_path / "jax" / ("m" + ext)).read_bytes()), ext
    for got in (MmapFileStore(tmp_path / "jax").get("m"),
                MmapFileStore(tmp_path / "jax", eager=True).get("m"),
                to_torch(JaxMmap(tmp_path / "port").get("m"))):
        back = _flat(to_numpy(got))
        assert back.keys() == leaves.keys()
        for k, a in leaves.items():
            assert back[k].dtype == a.dtype and back[k].tobytes() == \
                a.tobytes(), k
    ji, pi = JaxInt8(64), Int8BlockQuantizedStore(64)
    ji.put("m", tree)
    pi.put("m", to_torch(tree))
    jq, pq = _flat(ji._trees["m"]), _flat(pi._trees["m"])
    assert jq.keys() == pq.keys() == leaves.keys()
    for k in leaves:
        for part in ("codes", "scales"):
            a, b = getattr(jq[k], part), getattr(pq[k], part)
            assert np.asarray(a).tobytes() == b.numpy().tobytes(), (k, part)
    jback, pback = _flat(ji.get("m")), _flat(to_numpy(pi.get("m")))
    for k in leaves:
        assert pback[k].dtype == np.asarray(jback[k]).dtype
        assert pback[k].tobytes() == np.asarray(jback[k]).tobytes(), k
    assert pi.stored_bytes("m") == ji.stored_bytes("m")
