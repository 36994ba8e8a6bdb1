"""The port's examples (``examples/*_torch.py``) against the JAX package on
the CPU, loaded by path as a user runs them.

* quickstart: on JAX's reduced-expert weights (f32, through numpy) the
  forward logits agree within ATOL = 1e-4 (the dense parity tests' limit:
  f32, other summation orders), the 4 greedy decode steps give identical
  tokens (both dense caches in f32, as ``test_torch_coe_generate.py``
  patches them), and the fusion ledger's fields are equal.
* coe_serving: 3 experts of JAX's f32 weights, 8 requests of the
  example's trace, 2 slots, an HBM tier of 1.5 experts, under both
  schedulers: every request's tokens and routed expert, and the engine's
  switch / cache / pool counts, equal to JAX's engine's (its plain XLA
  body, f32 KV) driven through the same submit loop.
* train_expert: a tiny config's first 3 losses, and every loss of a whole
  60-step schedule (warmup, then the cosine to its end), from
  JAX-initialised f32 weights within ``test_torch_train.py``'s 1e-5
  relative of JAX's train step; a run checkpointed and resumed bit-equal
  to a straight run.
* Each ``main`` runs with ``--device cpu`` at small flags, and raises with
  ``--device cuda`` where there is no card."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import pathlib
import shutil

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
from repro.core.fusion import model_fusion_report as jax_fusion_report
from repro.data import DataConfig as JaxDataConfig
from repro.data import make_source as jax_make_source
from repro.distributed import stepfn as jax_stepfn
from repro.launch.mesh import make_mesh
from repro.models import get_model as jax_get_model
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.store import make_store as jax_make_store
from repro_torch.bridge import to_torch, tree_leaves
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.models import get_model
from repro_torch.models import transformer as T
from repro_torch.obs.trace import validate_chrome_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4
STEP_REL = 1e-5
CPU = torch.device("cpu")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


qs = _load("quickstart_torch")
cs = _load("coe_serving_torch")
te = _load("train_expert_torch")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _quiet(fn, *a, **k):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*a, **k)
    return res, out.getvalue()


def _cache_like_weights(monkeypatch):
    jspec, spec = JT.cache_spec, T.cache_spec
    monkeypatch.setattr(JT, "cache_spec", lambda *a: jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), jspec(*a)))
    monkeypatch.setattr(T, "cache_spec", lambda *a: {
        k: (sh, torch.float32) for k, (sh, _) in spec(*a).items()})


@pytest.fixture(scope="module")
def expert_trees():
    jcfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    m = jax_get_model(jcfg)
    rng = jax.random.PRNGKey(0)
    return jcfg, [_f32(m.init(jax.random.fold_in(rng, i))) for i in range(3)]


# ------------------------------------------------------------- quickstart
def test_quickstart_matches_jax(expert_trees, monkeypatch):
    _cache_like_weights(monkeypatch)
    jcfg, trees = expert_trees
    cfg = reduced(get_config("samba-coe-expert-7b"))
    jm, m = jax_get_model(jcfg), get_model(cfg)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                            qs.PROMPT).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)
    params = to_torch(trees[0])
    with torch.no_grad():
        got = qs.forward_logits(m, params, tt)
        steps = qs.prefill_and_decode(m, params, tt)
    want = jm.forward(trees[0], {"tokens": jt})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    last, cache = jm.prefill(trees[0], {"tokens": jt}, max_len=qs.MAX_LEN)
    tok = jnp.argmax(last, -1)
    for t in range(qs.DECODE_STEPS):
        lg, cache = jm.decode_step(trees[0], cache, tok[:, None],
                                   jnp.int32(qs.PROMPT[1] + t))
        tok = jnp.argmax(lg, -1)
        np.testing.assert_array_equal(steps[t], np.asarray(tok), str(t))
    rep = qs.model_fusion_report(get_config("samba-coe-expert-7b"), batch=8,
                                 ctx=4096)
    jrep = jax_fusion_report(jax_get_config("samba-coe-expert-7b"), batch=8,
                             ctx=4096)
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    for f in ("launch_ratio", "traffic_ratio", "intensity_unfused",
              "intensity_fused"):
        assert getattr(rep, f) == getattr(jrep, f), f


# ------------------------------------------------------------ coe_serving
def _jax_serve(jcfg, trees, args, reqs):
    nbytes = sum(a.nbytes for a in jax.tree.leaves(trees[0]))
    coe = JaxCoE(JaxHashRouter(len(trees)), None,
                 hbm_capacity_bytes=int(args.hbm_experts * nbytes),
                 kv_reserve_bytes=int(args.kv_reserve_experts * nbytes),
                 store=jax_make_store(args.store))
    for i, t in enumerate(trees):
        d = cs.DOMAINS[i % len(cs.DOMAINS)]
        coe.register(JaxHandle(f"expert-{d}-{i}", jcfg, t, domain=d))
    eng = JaxEngine(coe, jcfg, n_slots=args.n_slots,
                    scheduler=args.scheduler, backend="xla",
                    kv_dtype=jnp.float32, **cs.ENGINE)
    jreqs = [JaxRequest(rid=r.rid, tokens=r.tokens,
                        max_new_tokens=r.max_new_tokens, expert=r.expert)
             for r in reqs]
    try:
        done, _ = cs.serve(eng, jreqs)
    finally:
        coe.cache.close()
    return coe, eng, done


def _counts(coe, eng):
    st, c, p = eng.stats, coe.cache.stats, eng.pool.stats
    return dict(requests=st.requests, tokens_out=st.tokens_out,
                switches=st.switches, decode_rounds=st.decode_rounds,
                hits=c.hits, misses=c.misses, evictions=c.evictions,
                allocs=p.allocs, frees=p.frees, peak_blocks=p.peak_blocks,
                leaked=p.blocks_in_use)


def test_coe_serving_trace_is_the_jax_examples():
    """``make_trace`` draws what ``examples/coe_serving.py`` draws."""
    names = [f"e{i}" for i in range(3)]
    reqs, n_tagged = cs.make_trace(24, 0.25, names, 512)
    rs = np.random.RandomState(0)
    assert n_tagged == 6
    for i, r in enumerate(reqs):
        assert r.rid == i
        np.testing.assert_array_equal(r.tokens, rs.randint(0, 512, (16,)))
        assert r.tokens.dtype == np.int32
        assert r.max_new_tokens == int(rs.randint(4, 13))
        assert r.expert == (names[i % 3] if i < 6 else None)


@pytest.mark.parametrize("scheduler", ["continuous", "run_to_completion"])
def test_coe_serving_matches_jax_engine(expert_trees, scheduler):
    jcfg, trees = expert_trees
    cfg = reduced(get_config("samba-coe-expert-7b"))
    args = cs.parse_args(["--n-experts", "3", "--requests", "8",
                          "--n-slots", "2", "--hbm-experts", "1.5",
                          "--scheduler", scheduler, "--device", "cpu"])
    coe, eng = cs.build(cfg, [to_torch(t) for t in trees], args, CPU,
                        kv_dtype=torch.float32)
    reqs, n_tagged = cs.make_trace(args.requests, args.tagged_fraction,
                                   coe.expert_names(), cfg.vocab_size)
    try:
        done, _ = cs.serve(eng, reqs)
    finally:
        coe.cache.close()
    jcoe, jeng, jdone = _jax_serve(jcfg, trees, args, reqs)
    got = {r.rid: (r.expert, r.output) for r in done}
    want = {r.rid: (r.expert, r.output) for r in jdone}
    assert got.keys() == want.keys() == set(range(8))
    for rid, (expert, out) in want.items():
        assert got[rid][0] == expert, rid
        np.testing.assert_array_equal(got[rid][1], out, str(rid))
    assert len({e for e, _ in got.values()}) == 3
    counts = _counts(coe, eng)
    assert counts == _counts(jcoe, jeng)
    assert counts["leaked"] == 0 and counts["evictions"] > 0
    _, text = _quiet(cs.report, args, coe, eng, done, 1.0, n_tagged)
    assert "leaked=0" in text and f"[{scheduler}] served 8 requests" in text


# ----------------------------------------------------------- train_expert
def _tiny(cfg):
    return dataclasses.replace(cfg, name="expert-tiny", n_layers=2,
                               d_model=64, n_heads=4, n_kv_heads=4,
                               head_dim=16, d_ff=128, vocab_size=256)


def _train_args(tmp, steps, batch=2, seq=32):
    return te.parse_args(["--steps", str(steps), "--batch", str(batch),
                          "--seq", str(seq), "--ckpt", str(tmp),
                          "--device", "cpu"])


def test_train_expert_config_is_the_jax_examples():
    cfg, jcfg = te.expert_config(), jax_get_config("samba-coe-expert-7b")
    jcfg = dataclasses.replace(
        jcfg, name="expert-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=8, head_dim=64, d_ff=1536, vocab_size=32000,
        attn_chunk=128)
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "rope_theta"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.n_params() == jcfg.n_params()


def test_train_expert_first_losses_match_jax(tmp_path):
    cfg = _tiny(te.expert_config())
    jcfg = _tiny(jax_get_config("samba-coe-expert-7b"))
    params = _f32(jax_get_model(jcfg).init(jax.random.PRNGKey(0)))
    args = _train_args(tmp_path, 3)
    (_, losses, _), text = _quiet(te.train, cfg, args, CPU,
                                  params=to_torch(params))
    assert "step    0 loss=" in text and "step    2 loss=" in text
    mesh = make_mesh((1, 1), ("data", "model"))
    src = jax_make_source(JaxDataConfig(vocab_size=jcfg.vocab_size,
                                        seq_len=args.seq,
                                        global_batch=args.batch))
    want = []
    with mesh:
        fn, sh, _ = jax_stepfn.make_train_step(
            jcfg, mesh, JaxAdamWConfig(lr=1e-3, warmup_steps=20,
                                       decay_steps=args.steps))
        jp = jax.tree.map(jnp.asarray, params)
        state = jax.device_put({"params": jp,
                                "opt": jax_init_opt_state(jp)}, sh)
        for step in range(3):
            state, m = fn(state, jax.tree.map(jnp.asarray,
                                              src.batch_at(step)))
            want.append(float(m["loss"]))
    assert len(losses) == 3
    for got, w in zip(losses.tolist(), want):
        assert abs(got - w) <= STEP_REL * abs(w), (losses, want)


def test_train_expert_losses_match_jax_over_a_whole_schedule(tmp_path):
    """60 steps: the 20 of warmup to lr 1e-3 and the cosine decay over
    ``--steps`` to its end, every loss within STEP_REL of JAX's train step
    on the same batches. The loss falls to its least a few steps past
    warmup, then rises to the end, in JAX's run as in the port's: the
    synthetic batches of consecutive steps draw overlapping Philox streams
    (``counter=step``), which the model memorises at the peak rate and
    over-fits as the batches shift."""
    steps = 60
    cfg = _tiny(te.expert_config())
    jcfg = _tiny(jax_get_config("samba-coe-expert-7b"))
    params = _f32(jax_get_model(jcfg).init(jax.random.PRNGKey(0)))
    args = _train_args(tmp_path, steps)
    (_, losses, _), _ = _quiet(te.train, cfg, args, CPU,
                               params=to_torch(params))
    src = jax_make_source(JaxDataConfig(vocab_size=jcfg.vocab_size,
                                        seq_len=args.seq,
                                        global_batch=args.batch))
    want, mesh = [], make_mesh((1, 1), ("data", "model"))
    with mesh:
        fn, sh, _ = jax_stepfn.make_train_step(
            jcfg, mesh, JaxAdamWConfig(lr=1e-3, warmup_steps=20,
                                       decay_steps=steps))
        jp = jax.tree.map(jnp.asarray, params)
        state = jax.device_put({"params": jp,
                                "opt": jax_init_opt_state(jp)}, sh)
        for step in range(steps):
            state, m = fn(state, jax.tree.map(jnp.asarray,
                                              src.batch_at(step)))
            want.append(float(m["loss"]))
    got = losses.tolist()
    assert len(got) == steps
    for step, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= STEP_REL * abs(w), (step, g, w)
    for curve in (got, want):
        least = int(np.argmin(curve))
        assert 20 <= least < 40 and curve[-1] > curve[least] + 0.3, curve


def test_train_expert_resume_is_bit_equal_to_a_straight_run(tmp_path,
                                                           monkeypatch):
    """Checkpoints every 2 steps: a 5-step run whose last checkpoint is
    lost resumes from step 4 and ends bit-equal, on disk and in memory, to
    a straight 5-step run of another directory."""
    monkeypatch.setattr(te, "CKPT_EVERY", 2)
    cfg = _tiny(te.expert_config())
    a, b = tmp_path / "a", tmp_path / "b"
    _quiet(te.train, cfg, _train_args(a, 5), CPU)
    shutil.rmtree(a / "step-000000005")
    (resumed, losses, _), text = _quiet(te.train, cfg, _train_args(a, 5),
                                        CPU)
    assert "resumed from step 4" in text and len(losses) == 1
    (straight, _, _), _ = _quiet(te.train, cfg, _train_args(b, 5), CPU)
    for x, y in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert x.dtype == y.dtype and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
    fa, fb = a / "step-000000005", b / "step-000000005"
    names = sorted(p.name for p in fa.glob("*.npy"))
    assert names == sorted(p.name for p in fb.glob("*.npy")) and names
    for n in names:
        assert (fa / n).read_bytes() == (fb / n).read_bytes(), n
    assert CheckpointManager(str(a)).latest_step() == 5


# ------------------------------------------------------------------- mains
def test_mains_run_on_the_cpu(tmp_path):
    out, text = _quiet(qs.main, ["--device", "cpu"])
    assert "forward logits: (2, 16, 512)" in text
    assert "decode step 3 ->" in text
    # both activations spill at 10 MiB: the placement line claims no
    # sharing; allocate_static alone places both, at one address
    assert out["spilled"] == ["act_a", "act_b"]
    assert "placement: peak=9MiB spilled=['act_a', 'act_b']\n" in text
    static = out["static"].offsets
    assert static["act_a"] == static["act_b"] != static["kv_cache"]
    assert (f"allocate_static: peak=11MiB act_a@{static['act_a']} "
            f"act_b@{static['act_b']} (act_a/act_b share an address: "
            "True)") in text
    path = tmp_path / "trace.json"
    (coe, eng, done), text = _quiet(
        cs.main, ["--n-experts", "2", "--requests", "4", "--n-slots", "2",
                  "--device", "cpu", "--store", "int8",
                  "--trace", str(path)])
    assert "leaked=0" in text and len(done) == 4
    assert validate_chrome_trace(json.loads(path.read_text())) == []
    ckpt = tmp_path / "ckpt"
    (_, losses, _), text = _quiet(
        te.main, ["--device", "cpu", "--steps", "1", "--batch", "1",
                  "--seq", "16", "--ckpt", str(ckpt)])
    assert "training expert-100m: 60.0M params" in text
    assert text.rstrip().splitlines()[-1].startswith("done")
    assert len(losses) == 1 and torch.isfinite(losses).all()
    shutil.rmtree(ckpt)


def test_mains_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    for mod, argv in ((qs, []), (cs, ["--requests", "2"]),
                      (te, ["--steps", "1", "--ckpt", "/nonexistent"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _quiet(mod.main, argv)
