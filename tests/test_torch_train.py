"""The port's training path against the JAX package on the CPU: AdamW and
its schedule, the data pipeline, checkpoints across the two packages, the
attention backward's plain version, and the train step of the reduced
samba-coe-expert-7b and mixtral-8x7b in f32 (weights from JAX's init
through numpy), with accumulation and remat; then the trainer driver.

Tolerances. AdamW on random f32 leaves: params, moments, lr and grad norm
within 1e-6 of the largest |value| (both f32; the two frameworks fuse the
multiply-adds differently). Batches and restored checkpoints: equal byte
for byte. The attention backward: within 1e-5 of ``jax.vjp`` of JAX's
``naive_attention`` (f32, different summation orders). The train step over
3 steps in f32: the loss and the gradient norm each step within 1e-5
relative; each leaf's update (p_new - p_old) within a relative L2 error of
``UPDATE_REL_L2``: AdamW's first step moves a param by lr (g / (|g| + eps)
+ wd p), so a gradient entry within f32 noise of 0 can take the other sign
in the other framework and move its param by 2 lr the other way; updates
are compared, not raw params, which hide them under the params' size.
Both configs read at most 2.1e-4 (the first step; 2.4e-5 after), so the
limit is 1e-3."""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCkpt
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import DataConfig as JaxDataConfig
from repro.data import MemmapTokens as JaxMemmap
from repro.data import SyntheticLM as JaxSynthetic
from repro.distributed import stepfn as jax_stepfn
from repro.launch.mesh import make_mesh
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim import lr_schedule as jax_lr_schedule
from repro_torch.bridge import to_numpy, to_torch, tree_leaves
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, MemmapTokens, SyntheticLM
from repro_torch.distributed import stepfn
from repro_torch.kernels.flash_attention.ops import FlashAttention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_masked,
                                                     attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_mask,
                                                     attention_ref)
from repro_torch.kernels.lru_scan.ops import LruScan, lru_scan
from repro_torch.kernels.lru_scan.ref import lru_scan_bwd_ref, lru_scan_ref
from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,
                               lr_schedule)

UPDATE_REL_L2 = 1e-3
STEP_REL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, f"{what}: {err} > {tol}"


# ------------------------------------------------------------------ AdamW
def test_adamw_and_schedule_match_jax():
    rs = np.random.RandomState(0)
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 4, 2)}}
    params = jax.tree.map(lambda s: rs.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=5, grad_clip=0.5)
    jcfg, tcfg = JaxAdamWConfig(**cfg), AdamWConfig(**cfg)
    jp, jst = jax.tree.map(jnp.asarray, params), None
    jst = jax_init_opt_state(jp)
    tp = to_torch(params)
    tst = init_opt_state(tp)
    for step in range(5):
        grads = jax.tree.map(
            lambda p: (rs.standard_normal(p.shape) * 10 ** (step - 2))
            .astype(np.float32), params)
        jp, jst, jm = jax_adamw_update(jcfg, jp, jax.tree.map(
            jnp.asarray, grads), jst)
        tp, tst, tm = adamw_update(tcfg, tp, to_torch(grads), tst)
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            _close(b, a, 1e-6, f"param, step {step}")
        for part in ("mu", "nu"):
            for a, b in zip(jax.tree.leaves(jst[part]),
                            tree_leaves(tst[part])):
                _close(b, a, 1e-6, f"{part}, step {step}")
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        assert tst["step"].dtype == torch.int32
        _close(tm["lr"], jm["lr"], 1e-6, "lr")
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6, "grad_norm")
    for s in range(0, 12):
        want = float(jax_lr_schedule(jcfg, jnp.asarray(s, jnp.int32)))
        got = float(lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * cfg["lr"], s


# ------------------------------------------------------------------- data
def test_batches_byte_equal(tmp_path):
    corpus = tmp_path / "tokens.bin"
    np.random.RandomState(1).randint(0, 1000, 5000).astype(np.int32) \
        .tofile(corpus)
    for kw in (dict(vocab_size=512, seq_len=16, global_batch=4, seed=3),
               dict(vocab_size=1000, seq_len=32, global_batch=3,
                    corpus_path=str(corpus))):
        jsrc = (JaxMemmap if "corpus_path" in kw else JaxSynthetic)(
            JaxDataConfig(**kw))
        tsrc = (MemmapTokens if "corpus_path" in kw else SyntheticLM)(
            DataConfig(**kw))
        for step in (0, 1, 7):
            a, b = jsrc.batch_at(step), tsrc.batch_at(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (k, step)


# ------------------------------------------------------------ checkpoints
def _jax_state():
    cfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    params = jax_get_model(cfg).init(jax.random.PRNGKey(2))
    opt = jax_init_opt_state(params)
    opt = dict(opt, mu=jax.tree.map(lambda x: x + 0.5, opt["mu"]),
               step=jnp.asarray(7, jnp.int32))
    return {"params": params, "opt": opt}


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_checkpoints_restore_across_packages(tmp_path):
    js = _jax_state()
    # JAX writes, the port restores
    JaxCkpt(str(tmp_path / "j")).save(7, js)
    like = to_torch(to_numpy(to_torch(jax.tree.map(np.asarray, js))))
    got, step = CheckpointManager(str(tmp_path / "j")).restore_state(
        like, "cpu")
    assert step == 7
    want = to_torch(jax.tree.map(np.asarray, js))
    assert sorted(got) == ["opt", "params"]
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    # the port writes, JAX restores
    CheckpointManager(str(tmp_path / "t")).save(7, got)
    back, jstep = JaxCkpt(str(tmp_path / "t")).restore_state(js)
    assert jstep == 7
    for a, b in zip(_np_leaves(back), _np_leaves(js)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # the same manifests: keys, files, shapes and dtypes in the same order
    mj = json.loads((tmp_path / "j" / "step-000000007" / "manifest.json")
                    .read_text())
    mt = json.loads((tmp_path / "t" / "step-000000007" / "manifest.json")
                    .read_text())
    assert mj["keys"] == mt["keys"]


def test_checkpoint_retention_crash_safety_and_async(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
             "n": {"s": torch.tensor(3, dtype=torch.int32)}}
    m = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        m.save(step, state, extra={"at": step})
    assert sorted(p.name for p in tmp_path.glob("step-*")) == \
        ["step-000000002", "step-000000003"]
    assert m.latest_step() == 3
    # a crash mid-write leaves a staging dir and the old marker: restore
    # reads the last published step
    (tmp_path / ".tmp-4-999").mkdir()
    got, step = m.restore_state(state)
    assert step == 3 and torch.equal(got["w"], state["w"])
    # a marker naming a checkpoint that is gone falls back to the newest
    (tmp_path / "latest").write_text("step-000000009")
    assert m.latest_step() == 3
    # save_async: the state copied now, written on a thread
    live = {"w": state["w"].clone(), "n": {"s": state["n"]["s"].clone()}}
    m.save_async(5, live)
    live["w"].add_(1)
    m.wait()
    got, step = m.restore_state(state)
    assert step == 5 and torch.equal(got["w"], state["w"])
    assert int(got["n"]["s"]) == 3 and got["n"]["s"].dtype == torch.int32
    man = json.loads((tmp_path / "step-000000005" / "manifest.json")
                     .read_text())
    assert [e["dtype"] for e in man["keys"]] == ["int32", "bfloat16"]


# ------------------------------------------------------ attention backward
# (Sq, Sk, dk, dv, G, causal, window): causal, causal with a window, G 2;
# FULL (neither mask) with Sq != Sk both ways; dk != dv causal (MLA's
# shape, cut); G 16 on one kv head with a window (RecurrentGemma's, cut)
ATTN_GRAD_CASES = [
    (19, 19, 8, 8, 1, True, 0), (19, 19, 8, 8, 1, True, 5),
    (19, 19, 8, 8, 2, True, 0), (7, 23, 8, 8, 2, False, 0),
    (23, 7, 8, 8, 1, False, 0), (19, 19, 12, 8, 2, True, 0),
    (21, 21, 8, 8, 16, True, 6),
]


def _attn_inputs(Sq, Sk, dk, dv, G, seed):
    rs = np.random.RandomState(seed)
    B, Hkv = 2, 1 if G == 16 else 2
    return (rs.standard_normal((B, Sq, Hkv * G, dk)).astype(np.float32),
            rs.standard_normal((B, Sk, Hkv, dk)).astype(np.float32),
            rs.standard_normal((B, Sk, Hkv, dv)).astype(np.float32),
            rs.standard_normal((B, Sq, Hkv * G, dv)).astype(np.float32))


@pytest.mark.parametrize("Sq,Sk,dk,dv,G,causal,window", ATTN_GRAD_CASES)
def test_attention_bwd_ref_matches_jax_vjp(Sq, Sk, dk, dv, G, causal,
                                           window):
    q, k, v, do = _attn_inputs(Sq, Sk, dk, dv, G, G + window + Sq + 3 * Sk)
    _, vjp = jax.vjp(lambda a, b, c: JL.naive_attention(
        a, b, c, causal=causal, window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    got = attention_bwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v, do)), causal=causal,
        window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=f"{name} {causal} {window} {G}")


@pytest.mark.parametrize("Sq,Sk,dk,dv,G,causal,window", ATTN_GRAD_CASES)
def test_attention_bwd_rounded_ref_near_jax_vjp(Sq, Sk, dk, dv, G, causal,
                                                window):
    """``attention_bwd_masked(..., rounded=True)``, the formulas at the
    backward kernels' bf16 rounding points: every output a bf16 value,
    within a relative L2 error of 2^-6 of ``jax.vjp`` in f32 (a few bf16
    units), and off the unrounded formulas (the rounding takes effect)."""
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in _attn_inputs(
        Sq, Sk, dk, dv, G, G + window + Sq + 3 * Sk)]
    mask = attention_mask(Sq, Sk, causal=causal, window=window)
    got = attention_bwd_masked(*args, mask, rounded=True)
    plain = attention_bwd_masked(*args, mask)
    q, k, v, do = (np.asarray(t.float()) for t in args)
    _, vjp = jax.vjp(lambda a, b, c: JL.naive_attention(
        a, b, c, causal=causal, window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        assert torch.equal(g, g.to(torch.bfloat16).float()), name
        assert not torch.equal(g, p), name
        w = torch.from_numpy(np.array(w))
        assert float((g - w).norm() / w.norm()) < 2.0 ** -6, name


@pytest.mark.parametrize("Sq,Sk,dk,dv,G,causal,window", ATTN_GRAD_CASES)
def test_attention_lse_ref_matches_jax(Sq, Sk, dk, dv, G, causal, window):
    """o against JAX's naive attention, lse against JAX's log-sum-exp of
    the scaled, masked scores (``_gqa_scores``), atol 1e-5."""
    q, k, v, _ = _attn_inputs(Sq, Sk, dk, dv, G, 5 * G + window + Sq + Sk)
    B, Hq, Hkv = q.shape[0], q.shape[2], k.shape[2]
    s = JL._gqa_scores(jnp.asarray(q).reshape(B, Sq, Hkv, G, dk),
                       jnp.asarray(k), 1.0 / np.sqrt(dk))
    qpos, kpos = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    want_lse = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1) \
        .reshape(B, Hq, Sq)
    want_o = JL.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window)
    o, lse = attention_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=causal, window=window)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=1e-5)


@pytest.mark.parametrize("Sq,Sk,dk,dv,G,causal,window", ATTN_GRAD_CASES)
def test_flash_attention_function_on_cpu(Sq, Sk, dk, dv, G, causal, window):
    """``FlashAttention.apply`` on CPU tensors (its forward the LSE form's
    plain version, its backward ``attention_bwd``'s) gives autograd
    through the plain forward's output and gradients, atol 1e-5."""
    q, k, v, do = (torch.from_numpy(x) for x in _attn_inputs(
        Sq, Sk, dk, dv, G, 7 * G + window + Sq))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_o = attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(want_o, leaves, do)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = FlashAttention.apply(*leaves, causal, window)
    got = torch.autograd.grad(o, leaves, do)
    torch.testing.assert_close(o, want_o, atol=1e-5, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=name)


# ------------------------------------------------------ lru_scan backward
def _scan_inputs(B, S, D, seed):
    rs = np.random.RandomState(seed)
    return (rs.uniform(0.3, 1.0, (B, S, D)).astype(np.float32),
            rs.standard_normal((B, S, D)).astype(np.float32),
            rs.standard_normal((B, S, D)).astype(np.float32))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("B,S,D", [(2, 37, 24), (1, 2, 8), (3, 50, 5)])
def test_lru_scan_bwd_ref_matches_jax_vjp(B, S, D):
    """``lru_scan_bwd_ref`` against ``jax.vjp`` of the RG-LRU's
    ``associative_scan`` (``repro.models.rglru.rec_block``), at S off the
    kernel's 16-step chunks: da and db within 1e-5 relative L2."""
    a, b, dh = _scan_inputs(B, S, D, S + D)

    def scan(a_, b_):
        return jax.lax.associative_scan(
            lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
            (a_, b_), axis=1)[1]
    h, vjp = jax.vjp(scan, jnp.asarray(a), jnp.asarray(b))
    want_da, want_db = vjp(jnp.asarray(dh))
    da, db = lru_scan_bwd_ref(torch.from_numpy(a),
                              torch.from_numpy(np.array(h)),
                              torch.from_numpy(dh))
    assert _rel_l2(da.numpy(), want_da) < 1e-5
    assert _rel_l2(db.numpy(), want_db) < 1e-5


def test_lru_scan_function_on_cpu():
    """``LruScan.apply`` on CPU tensors (its forward and backward the plain
    versions) gives autograd through ``lru_scan_ref``'s output and
    gradients; ``lru_scan`` on CPU tensors takes that autograd path."""
    a, b, dh = (torch.from_numpy(x) for x in _scan_inputs(2, 37, 24, 1))
    leaves = [t.clone().requires_grad_(True) for t in (a, b)]
    want_h = lru_scan_ref(*leaves)
    want = torch.autograd.grad(want_h, leaves, dh)
    leaves = [t.clone().requires_grad_(True) for t in (a, b)]
    h = LruScan.apply(*leaves)
    got = torch.autograd.grad(h, leaves, dh)
    torch.testing.assert_close(h, want_h, atol=0, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    leaves = [t.clone().requires_grad_(True) for t in (a, b)]
    got = torch.autograd.grad(lru_scan(*leaves), leaves, dh)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------------- train step
def _cfgs(arch):
    return jax_reduced(jax_get_config(arch)), reduced(get_config(arch))


def _f32_params(jcfg, seed=1):
    p = jax_get_model(jcfg).init(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), p)


def _batches(cfg, n, B=4, S=32):
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                 global_batch=B, seed=5))
    return [src.batch_at(i) for i in range(n)]


OPT = dict(warmup_steps=2, decay_steps=4)


def _jax_run(jcfg, params, batches, accum_steps=1):
    mesh = make_mesh((1, 1), ("data", "model"))
    with mesh:
        fn, sh, _ = jax_stepfn.make_train_step(
            jcfg, mesh, JaxAdamWConfig(**OPT), accum_steps=accum_steps)
        jp = jax.tree.map(jnp.asarray, params)
        state = jax.device_put({"params": jp, "opt": jax_init_opt_state(jp)},
                               sh)
        out = []
        for b in batches:
            state, m = fn(state, jax.tree.map(jnp.asarray, b))
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        jax.tree.map(np.asarray, state["params"])))
    return out


def _port_run(cfg, params, batches, accum_steps=1, remat=True):
    fn = stepfn.make_train_step(cfg, AdamWConfig(**OPT), remat=remat,
                                accum_steps=accum_steps)
    state = stepfn.init_train_state(to_torch(params))
    out = []
    for b in batches:
        state, m = fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    to_numpy(state["params"])))
    return out


def _compare(label, params, got, want):
    prev_g, prev_w = params, params
    for i, ((lg, ng, pg), (lw, nw, pw)) in enumerate(zip(got, want)):
        assert abs(lg - lw) <= STEP_REL * abs(lw), (label, i, lg, lw)
        assert abs(ng - nw) <= STEP_REL * abs(nw), (label, i, ng, nw)
        flat_g = jax.tree_util.tree_flatten_with_path(pg)[0]
        flat_w = dict(jax.tree_util.tree_flatten_with_path(pw)[0])
        flat_pg = dict(jax.tree_util.tree_flatten_with_path(prev_g)[0])
        flat_pw = dict(jax.tree_util.tree_flatten_with_path(prev_w)[0])
        for path, a in flat_g:
            ug = a.astype(np.float64) - flat_pg[path]
            uw = flat_w[path].astype(np.float64) - flat_pw[path]
            err = np.linalg.norm(ug - uw) / max(np.linalg.norm(uw), 1e-30)
            assert err <= UPDATE_REL_L2, (label, i,
                                          jax.tree_util.keystr(path), err)
        prev_g, prev_w = pg, pw


@pytest.mark.parametrize("arch", ["samba-coe-expert-7b", "mixtral-8x7b"])
def test_train_step_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    params = _f32_params(jcfg)
    batches = _batches(cfg, 3)
    _compare(arch, params, _port_run(cfg, params, batches),
             _jax_run(jcfg, params, batches))


def test_accumulation_matches_jax_and_remat_is_exact():
    jcfg, cfg = _cfgs("samba-coe-expert-7b")
    params = _f32_params(jcfg, seed=3)
    batches = _batches(cfg, 2)
    got = _port_run(cfg, params, batches, accum_steps=2)
    _compare("accum_steps=2", params, got,
             _jax_run(jcfg, params, batches, accum_steps=2))
    # remat changes what is kept, not what is computed
    off = _port_run(cfg, params, batches, accum_steps=2, remat=False)
    for (la, na, pa), (lb, nb, pb) in zip(got, off):
        assert la == lb and na == nb
        for a, b in zip(jax.tree.leaves(pa), jax.tree.leaves(pb)):
            assert a.tobytes() == b.tobytes()


def test_trainer_cpu_passes_its_own_check(tmp_path):
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train.main(["--arch", "samba-coe-expert-7b", "--reduced",
                             "--device", "cpu", "--steps", "6",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every",
                             "3"])
    text = out.getvalue()
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert f"loss {losses[0]:.4f} -> {losses[-1]:.4f} OK" in text
    assert CheckpointManager(str(tmp_path)).latest_step() == 6
    with pytest.raises(ValueError, match="torchrun"):
        train.main(["--arch", "samba-coe-expert-7b", "--reduced",
                    "--device", "cpu", "--mesh", "2x2"])
