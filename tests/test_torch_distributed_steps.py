"""The mesh serving steps, the mesh MoE and the training driver on the
CPU, against the port's single-device functions and the JAX package: gloo
groups of 1, 2 and 4 ranks (``_torch_ranks``):

  * ``make_prefill_step`` / ``make_decode_step`` on a (2, 2) mesh with
    reduced granite-8b (JAX's params through ``bridge``, f32): the prefill's
    logits within 2e-2 of the single-device ``prefill``'s and of JAX's, the
    cache in ``cache_pspecs``' placements, eight greedy decode steps with
    logits within 2e-2 and tokens identical to the single-device
    ``decode_step``'s; the production meshes refuse a group of 4, naming
    it;
  * ``moe_apply`` of DTensors with ``moe_ep_local`` off equals the
    single-device ``moe_apply`` (capacity from all B * S tokens, the same
    drops) and JAX's, at capacity factor 0.5 (assignments dropped), with
    the experts sharded over 'model' and, at 3 experts, with each expert's
    hidden dim sharded instead;
  * ``moe_dispatch_constraint``'s pinned buffers (sharded by expert over
    'model') keep the mesh MoE's output and gradients (1 x 2 and 2 x 2
    meshes);
  * EP-local MoE (``moe_ep_local``: each data shard routes its own tokens
    to each rank's E / tp experts, one reduction over 'model') within 0.02
    of the global dispatch (JAX's reduced DeepSeek variant: 4 experts, top
    2, capacity factor 16, no shared expert), and of JAX's
    ``moe_apply_ep_local`` on the same inputs (4 host devices);
  * a (1, 1) mesh is the single-device step: two train steps' losses,
    grad norms and params, and a prefill and eight decode steps' logits,
    bit-equal."""
import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import ROOT, env, load, run_ranks, save
from repro.configs import get_config as jax_get_config
from repro.configs import pad_for_tp as jax_pad_for_tp
from repro.configs import reduced as jax_reduced
from repro.models import get_model as jax_get_model
from repro_torch.bridge import to_torch, tree_map
from repro_torch.configs import get_config, pad_for_tp, reduced
from repro_torch.models import get_model
from repro_torch.models import layers as L

LOGIT_TOL_REL = 2e-2
MOE_TOL_REL = 1e-5              # f32: the same sums, in another grouping
EP_LOCAL_TOL_REL = 0.02
N_DECODE = 8


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_prefill_decode_steps_on_2x2(tmp_path):
    jcfg = jax_pad_for_tp(jax_reduced(jax_get_config("granite-8b")), 2)
    cfg = pad_for_tp(reduced(get_config("granite-8b")), 2)
    jm = jax_get_model(jcfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jm.init(jax.random.PRNGKey(0)))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                       cfg.vocab_size))
    jlogits, _ = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32)
    params = to_torch(jax.tree.map(np.asarray, jparams))
    m = get_model(cfg)
    logits, cache = m.prefill(params, {"tokens": torch.from_numpy(toks)}, 32)
    ref = [logits]
    tok = logits.argmax(-1)[:, None]
    for i in range(N_DECODE):
        logits, cache = m.decode_step(params, cache, tok, 16 + i)
        tok = logits.argmax(-1)[:, None]
        ref.append(logits)
    save(tmp_path, {"cfg": cfg, "params": params, "tokens": toks})
    run_ranks("""
        from repro_torch.distributed import partitioning as part, stepfn
        from repro_torch.launch.mesh import make_mesh, make_production_mesh
        inp = torch.load(f"{TMP}/in.pt", weights_only=False)
        cfg = inp["cfg"]
        mesh = make_mesh((2, 2), ("data", "model"))
        prefill, psh, csh = stepfn.make_prefill_step(cfg, mesh, 32, batch=4)
        decode, _, _ = stepfn.make_decode_step(cfg, mesh, batch=4,
                                               max_len=32)
        params = part.device_put(inp["params"], psh)
        logits, cache = prefill(params, {"tokens": torch.from_numpy(
            inp["tokens"])})
        placed = {k: (str(v.placements), str(csh[k].placements))
                  for k, v in cache.items()}
        out = [logits.full_tensor()]
        for i in range(8):
            tok = out[-1].argmax(-1)[:, None]
            logits, cache = decode(params, cache, tok, 16 + i)
            out.append(logits.full_tensor())
        refused = []
        for multi_pod in (False, True):
            try:
                make_production_mesh(multi_pod=multi_pod)
            except ValueError as e:
                refused.append(str(e))
        emit("steps", {"logits": out, "placed": placed,
                       "logits_placements": str(logits.placements),
                       "refused": refused})
    """, 4, tmp_path)
    got = load(tmp_path, "steps")
    assert _rel(got["logits"][0], np.asarray(jlogits)) < LOGIT_TOL_REL
    for g, r in zip(got["logits"], ref):
        assert _rel(g, r) < LOGIT_TOL_REL
        assert torch.equal(g.argmax(-1), r.argmax(-1))
    for k, (have, want) in got["placed"].items():
        assert have == want == "(Shard(dim=1), Shard(dim=3))", k
    assert got["logits_placements"] == "(Shard(dim=0), Replicate())"
    assert len(got["refused"]) == 2
    assert all("4" in e and "256" in e or "512" in e for e in got["refused"])


@pytest.mark.parametrize("n_experts", [4, 3])
def test_mesh_moe_equals_single_device(tmp_path, n_experts):
    from repro.models.common import init_params as jax_init_params
    from repro.models.layers import moe_apply as jax_moe_apply
    from repro.models.layers import moe_specs as jax_moe_specs
    jcfg = dataclasses.replace(
        jax_pad_for_tp(jax_reduced(jax_get_config("mixtral-8x7b")), 2),
        capacity_factor=0.5, n_experts=n_experts)
    cfg = dataclasses.replace(
        pad_for_tp(reduced(get_config("mixtral-8x7b")), 2),
        capacity_factor=0.5, n_experts=n_experts)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jax_init_params(
        jax.random.PRNGKey(0), jax_moe_specs(jcfg)))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, 8, cfg.d_model)), np.float32)
    jref = np.asarray(jax_moe_apply(jcfg, jax.tree.map(jnp.asarray, jp),
                                    jnp.asarray(x)))
    p, xt = to_torch(jp), torch.from_numpy(x.copy())
    ref = L.moe_apply(cfg, p, xt)
    _, _, topi = L.moe_route(cfg, p["router"], xt.reshape(-1, cfg.d_model))
    _, _, rank = L.moe_dispatch(cfg, topi)
    assert int((rank >= L.moe_capacity(cfg, 32)).sum()) > 0   # drops
    save(tmp_path, {"cfg": cfg, "p": p, "x": xt})
    run_ranks("""
        from repro_torch.distributed import partitioning as part, stepfn
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import layers as L
        inp = torch.load(f"{TMP}/in.pt", weights_only=False)
        cfg = inp["cfg"]
        mesh = make_mesh((2, 2), ("data", "model"))
        p = part.device_put(inp["p"], part.shardings_from_pspecs(
            part.param_pspecs(L.moe_specs(cfg), mesh), mesh))
        x = part.distribute(inp["x"], part.NamedSharding(mesh, part.P("data")))
        with stepfn.on_mesh(mesh):
            out = L.moe_apply(cfg, p, x)
        emit("moe", {"out": out.full_tensor(), "placements":
                     str(out.placements),
                     "experts": str(p["experts"]["wi_gate"].placements)})
    """, 4, tmp_path)
    got = load(tmp_path, "moe")
    assert got["placements"] == "(Shard(dim=0), Replicate())"
    assert got["experts"] == ("(Replicate(), Shard(dim=0))" if n_experts == 4
                              else "(Replicate(), Shard(dim=2))")
    assert _rel(got["out"], ref) < MOE_TOL_REL
    assert _rel(got["out"], jref) < MOE_TOL_REL


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_moe_dispatch_constraint_keeps_output_and_gradients(tmp_path, shape):
    """``PerfOptions.moe_dispatch_constraint`` on a (1, 2) and a (2, 2)
    gloo mesh: 4 experts by expert over 'model' (2 a rank), capacity
    factor 0.5 (assignments dropped); on (2, 2) the tokens are sharded
    over 'data', so the routing is gathered across data ranks and the
    router's gradient is a partial sum over them. With the field on,
    under the named placements the dry-run sets
    (``ctx.moe_dispatch_named``), the dispatch and result buffers are
    DTensors sharded by expert over 'model'; the output, and the gradients
    of x, the router and the experts, equal the field off within
    MOE_TOL_REL, and the output the single-device ``moe_apply``."""
    cfg = dataclasses.replace(
        pad_for_tp(reduced(get_config("mixtral-8x7b")), 2),
        capacity_factor=0.5, n_experts=4)
    from repro.models.common import init_params as jax_init_params
    from repro.models.layers import moe_specs as jax_moe_specs
    jcfg = dataclasses.replace(
        jax_pad_for_tp(jax_reduced(jax_get_config("mixtral-8x7b")), 2),
        capacity_factor=0.5, n_experts=4)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jax_init_params(
        jax.random.PRNGKey(0), jax_moe_specs(jcfg)))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, 8, cfg.d_model)), np.float32)
    p, xt = to_torch(jp), torch.from_numpy(x.copy())
    ref = L.moe_apply(cfg, p, xt)
    save(tmp_path, {"cfg": cfg, "p": p, "x": xt, "shape": shape})
    run_ranks("""
        from repro_torch.distributed import ctx, partitioning as part, stepfn
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import layers as L
        inp = torch.load(f"{TMP}/in.pt", weights_only=False)
        cfg = inp["cfg"]
        mesh = make_mesh(inp["shape"], ("data", "model"))
        seen, res = [], {}
        pin = ctx.constrain_named

        def spy(name, t):
            out = pin(name, t)
            seen.append((name, tuple(t.shape), str(out.placements)))
            return out

        ctx.constrain_named = spy
        for on in (False, True):
            p = part.device_put(inp["p"], part.shardings_from_pspecs(
                part.param_pspecs(L.moe_specs(cfg), mesh), mesh))
            leaves = [p["router"], *p["experts"].values()]
            for t in leaves:
                t.requires_grad_(True)
            x = part.distribute(inp["x"].clone(),
                                part.NamedSharding(mesh, part.P("data")))
            x.requires_grad_(True)
            with ctx.perf_options(ctx.PerfOptions(
                    moe_dispatch_constraint=on)), stepfn.on_mesh(mesh), \
                    ctx.named_shardings(**ctx.moe_dispatch_named(cfg, mesh)):
                out = L.moe_apply(cfg, p, x)
                out.full_tensor().pow(2).sum().backward()
            res[on] = [out.full_tensor().detach(), x.grad.full_tensor()] + [
                t.grad.full_tensor() for t in leaves]
        emit("pinned", {"res": res, "seen": seen})
    """, shape[0] * shape[1], tmp_path)
    got = load(tmp_path, "pinned")
    E, C = 4, L.moe_capacity(cfg, 32)
    assert got["seen"] == [("moe_dispatch", (E, C, cfg.d_model),
                            "(Replicate(), Shard(dim=0))")] * 2
    for on, off in zip(got["res"][True], got["res"][False]):
        assert _rel(on, off) < MOE_TOL_REL
    assert _rel(got["res"][True][0], ref) < MOE_TOL_REL


_JAX_EP_LOCAL = """
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_mesh
    from repro.models.layers import moe_apply_ep_local
    cfg, p, x = pickle.load(open(sys.argv[1] + "/jax_in.pkl", "rb"))
    p = jax.tree.map(jnp.asarray, p)
    with make_mesh((2, 2), ("data", "model")) as mesh:
        out = jax.jit(lambda p, x: moe_apply_ep_local(cfg, p, x, mesh))(
            p, jnp.asarray(x))
    np.save(sys.argv[1] + "/jax_out.npy", np.asarray(out, np.float32))
"""


def test_moe_ep_local_matches_global_dispatch(tmp_path):
    import pickle

    from repro.models.common import init_params as jax_init_params
    from repro.models.layers import moe_specs as jax_moe_specs
    jcfg = dataclasses.replace(
        jax_reduced(jax_get_config("deepseek-v2-lite-16b")), n_experts=4,
        top_k=2, capacity_factor=16.0, n_shared_experts=0)
    cfg = dataclasses.replace(
        reduced(get_config("deepseek-v2-lite-16b")), n_experts=4, top_k=2,
        capacity_factor=16.0, n_shared_experts=0)
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0),
                                                  jax_moe_specs(jcfg)))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, 8, cfg.d_model)).astype(jnp.bfloat16))
    with open(tmp_path / "jax_in.pkl", "wb") as f:
        pickle.dump((jcfg, jp, x), f)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_EP_LOCAL), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env(), cwd=ROOT)
    from repro_torch.bridge import array_to_tensor
    from repro_torch.models import layers as L
    p, xt = to_torch(jp), array_to_tensor(x)
    ref = L.moe_apply(cfg, p, xt).float()
    save(tmp_path, {"cfg": cfg, "p": p, "x": xt})
    run_ranks("""
        from repro_torch.distributed import ctx, partitioning as part, stepfn
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import layers as L
        inp = torch.load(f"{TMP}/in.pt", weights_only=False)
        cfg = inp["cfg"]
        mesh = make_mesh((2, 2), ("data", "model"))
        sh = part.shardings_from_pspecs(
            part.param_pspecs(L.moe_specs(cfg), mesh), mesh)
        p = part.device_put(inp["p"], sh)
        x = part.distribute(inp["x"], part.NamedSharding(mesh, part.P("data")))
        with ctx.perf_options(ctx.PerfOptions(moe_ep_local=True)), \\
                stepfn.on_mesh(mesh):
            out = L.moe_apply(cfg, p, x)
        emit("ep_local", {"out": out.full_tensor().float(),
                          "experts": str(p["experts"]["wo"].placements)})
    """, 4, tmp_path)
    out, _ = jax_proc.communicate(timeout=240)
    assert jax_proc.returncode == 0, out
    jax_out = np.load(tmp_path / "jax_out.npy")
    got = load(tmp_path, "ep_local")
    assert got["experts"] == "(Replicate(), Shard(dim=0))"
    scale = float(ref.abs().max())
    assert float((got["out"] - ref).abs().max()) / scale < EP_LOCAL_TOL_REL
    assert float(np.max(np.abs(got["out"].numpy() - jax_out))) / scale \
        < EP_LOCAL_TOL_REL


def test_one_by_one_mesh_is_the_single_device_step(tmp_path):
    from repro_torch.data import DataConfig, make_source
    from repro_torch.distributed import stepfn
    from repro_torch.optim import AdamWConfig
    cfg = reduced(get_config("samba-coe-expert-7b"))
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    batch = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4)).batch_at(0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=4)
    save(tmp_path, {"cfg": cfg, "params": params, "batch": batch,
                    "opt": opt})
    fn = stepfn.make_train_step(cfg, opt)
    state = stepfn.init_train_state(tree_map(torch.clone, params))
    metrics = []
    for _ in range(2):
        state, met = fn(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
    toks = torch.from_numpy(batch["tokens"][:, :16])
    logits, cache = m.prefill(params, {"tokens": toks}, 32)
    served = [logits]
    for i in range(N_DECODE):
        logits, cache = m.decode_step(params, cache,
                                      logits.argmax(-1)[:, None], 16 + i)
        served.append(logits)
    run_ranks("""
        from repro_torch.bridge import tree_items, tree_map
        from repro_torch.distributed import partitioning as part, stepfn
        from repro_torch.launch.mesh import single_device_mesh
        inp = torch.load(f"{TMP}/in.pt", weights_only=False)
        cfg, batch = inp["cfg"], inp["batch"]
        mesh = single_device_mesh()
        fn, sh, bsh = stepfn.make_train_step(cfg, inp["opt"], mesh=mesh)
        # a (1, 1) mesh's shard is the tensor itself: train on a copy
        state = part.device_put(stepfn.init_train_state(
            tree_map(torch.clone, inp["params"])), sh)
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        metrics = []
        for _ in range(2):
            state, met = fn(state, part.device_put(b, bsh(b)))
            metrics.append((float(met["loss"]), float(met["grad_norm"])))
        params = {n: x.to_local() for n, x in tree_items(state["params"])}
        prefill, psh, _ = stepfn.make_prefill_step(cfg, mesh, 32, batch=4)
        decode, _, _ = stepfn.make_decode_step(cfg, mesh, batch=4, max_len=32)
        p = part.device_put(inp["params"], psh)
        logits, cache = prefill(p, {"tokens": b["tokens"][:, :16]})
        served = [logits.to_local()]
        for i in range(8):
            logits, cache = decode(p, cache, served[-1].argmax(-1)[:, None],
                                   16 + i)
            served.append(logits.to_local())
        emit("one", {"metrics": metrics, "params": params,
                     "served": served})
    """, 1, tmp_path)
    from repro_torch.bridge import tree_items
    got = load(tmp_path, "one")
    assert got["metrics"] == metrics
    for n, x in tree_items(state["params"]):
        assert torch.equal(got["params"][n], x), n
    for g, r in zip(got["served"], served):
        assert torch.equal(g, r)

