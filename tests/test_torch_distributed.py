"""Distribution of the port on the CPU, against the JAX package: a 4-rank
gloo group (one process a rank, ``_torch_ranks.run_ranks``), the
counterparts of JAX's multi-device tests of the sharded forward, the
pipeline and the compressed all-reduce (``tests/test_distributed.py``),
each at JAX's own bound:

  * reduced granite-8b (``pad_for_tp(..., 2)``, JAX's params carried over
    through ``bridge``) on a (2, 2) ('data', 'model') mesh: the forward
    within 2e-2 of the largest logit of the port's single-device forward
    and of JAX's; then two GQA variants whose kv heads the 'model' axis
    does not divide (one kv head: each rank attends with it at G 2; six q
    heads on three kv heads: a rank's q heads straddle kv heads), f32,
    forward and every leaf's gradient against the single-device port's;
  * GPipe over a 4-stage mesh within 1e-5 of ``sequential_apply`` and of
    JAX's ``pipeline_apply`` on the same input;
  * the int8 compressed all-reduce over a 4-rank 'data' axis within 0.02
    of the exact mean and within 1e-6 of JAX's
    ``make_compressed_allreduce``;
  * ``python -m repro_torch.launch.train --mesh 1x2`` under ``torchrun``
    with two ranks trains and passes its own check.

JAX's outputs that need 4 devices come from one JAX subprocess on 4 host
devices."""
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

FORWARD_TOL_REL = 2e-2          # JAX's bound for the sharded forward
F32_TOL_REL = 1e-5
PIPELINE_ATOL = 1e-5
COMPRESS_TOL_REL = 0.02
COMPRESS_VS_JAX_REL = 1e-6


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_sharded_forward_equals_single_device(tmp_path):
    jcfg = jax_pad_for_tp(jax_reduced(jax_get_config("granite-8b")), 2)
    cfg = pad_for_tp(reduced(get_config("granite-8b")), 2)
    jm = jax_get_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0,
                                         cfg.vocab_size))
    jax_ref = np.asarray(jm.forward(jparams, {"tokens": jnp.asarray(toks)})
                         .astype(jnp.float32))
    params = to_torch(jax.tree.map(np.asarray, jparams))
    m = get_model(cfg)
    ref = m.forward(params, {"tokens": torch.from_numpy(toks)}).float()
    # GQA variants that 'model' does not divide, f32, with gradients
    gqa = {}
    for name, heads in (("kv1", (4, 1)), ("q6kv3", (6, 3))):
        c = dataclasses.replace(cfg, n_heads=heads[0], n_kv_heads=heads[1])
        p = get_model(c).init(torch.Generator().manual_seed(2), "cpu")
        p = tree_map(lambda x: x.float(), p)
        leaves = dict(_grads(c, p, torch.from_numpy(toks)))
        gqa[name] = (c, p, leaves)
    save(tmp_path, {"cfg": cfg, "params": params, "tokens": toks,
                    "gqa": {k: v[:2] for k, v in gqa.items()}})
    run_ranks("""
        from repro_torch.bridge import tree_items
        from repro_torch.distributed import partitioning as part, stepfn
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import get_model
        inp = torch.load(f"{TMP}/in.pt", weights_only=False)
        mesh = make_mesh((2, 2), ("data", "model"))
        toks = part.distribute(torch.from_numpy(inp["tokens"]),
                               part.NamedSharding(mesh, part.P("data")))

        def shard(cfg, params):
            m = get_model(cfg)
            sh = part.shardings_from_pspecs(
                part.param_pspecs(m.param_specs(), mesh), mesh)
            return m, part.device_put(params, sh)

        m, params = shard(inp["cfg"], inp["params"])
        with stepfn.on_mesh(mesh):
            out = m.forward(params, {"tokens": toks})
        emit("forward", out.full_tensor().float())
        for name, (cfg, p) in inp["gqa"].items():
            m, p = shard(cfg, p)
            names, leaves = zip(*tree_items(p))
            for x in leaves:
                x.requires_grad_(True)
            with stepfn.on_mesh(mesh):
                out = m.forward(p, {"tokens": toks})
                loss = out.float().square().mean()
                grads = torch.autograd.grad(loss, leaves)
            emit(name, {"logits": out.full_tensor().detach(),
                        "grads": {n: g.redistribute(x.device_mesh,
                                                    x.placements)
                                  .full_tensor()
                                  for n, g, x in zip(names, grads, leaves)}})
    """, 4, tmp_path)
    got = load(tmp_path, "forward").numpy()
    assert _rel(got, ref.numpy()) < FORWARD_TOL_REL
    assert _rel(got, jax_ref) < FORWARD_TOL_REL
    for name, (c, p, want) in gqa.items():
        out = load(tmp_path, name)
        assert _rel(out["logits"], want["logits"]) < F32_TOL_REL, name
        for n, g in out["grads"].items():
            assert _rel(g, want[n]) < F32_TOL_REL, (name, n)


def _grads(cfg, params, toks):
    from repro_torch.bridge import tree_items
    m = get_model(cfg)
    names, leaves = zip(*tree_items(params))
    for x in leaves:
        x.requires_grad_(True)
    out = m.forward(params, {"tokens": toks})
    grads = torch.autograd.grad(out.float().square().mean(), leaves)
    yield "logits", out.detach()
    yield from zip(names, grads)


_JAX_4_DEVICES = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.compression import make_compressed_allreduce
    from repro.distributed.pipeline import pipeline_apply
    from repro.launch.mesh import make_mesh
    d = np.load(sys.argv[1] + "/jax_in.npz")
    fn = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
    params = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}
    y = pipeline_apply(fn, params, jnp.asarray(d["x"]),
                       make_mesh((4,), ("stage",)))
    red = make_compressed_allreduce(make_mesh((4,), ("data",)), "data")(
        {"g": jnp.asarray(d["g"])})["g"]
    np.savez(sys.argv[1] + "/jax_out.npz", pipeline=np.asarray(y),
             compressed=np.asarray(red))
"""


def _jax_on_4_devices(tmp_path):
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_4_DEVICES),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env(), cwd=ROOT)


def test_pipeline_and_compressed_allreduce(tmp_path):
    rng = np.random.RandomState(0)
    S, M, D = 4, 6, 16
    w = (rng.randn(S, D, D) * 0.3).astype(np.float32)
    b = rng.randn(S, D).astype(np.float32)
    x = rng.randn(M, 8, D).astype(np.float32)
    g = rng.randn(4, 64).astype(np.float32)
    np.savez(tmp_path / "jax_in.npz", w=w, b=b, x=x, g=g)
    jax_proc = _jax_on_4_devices(tmp_path)
    save(tmp_path, {"w": w, "b": b, "x": x, "g": g})
    run_ranks("""
        import numpy as np
        from repro_torch.distributed import partitioning as part
        from repro_torch.distributed.compression import (
            make_compressed_allreduce)
        from repro_torch.distributed.pipeline import (pipeline_apply,
                                                      sequential_apply)
        from repro_torch.launch.mesh import make_mesh
        inp = torch.load(f"{TMP}/in.pt", weights_only=False)
        fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
        mesh = make_mesh((4,), ("stage",))
        params = {k: torch.from_numpy(inp[k]) for k in ("w", "b")}
        # each rank holds its stage's slice only
        sh = part.NamedSharding(mesh, part.P("stage"))
        y = pipeline_apply(fn, {k: part.distribute(v, sh)
                                for k, v in params.items()},
                           torch.from_numpy(inp["x"]), mesh)
        emit("pipeline", {"y": y, "seq": sequential_apply(
            fn, params, torch.from_numpy(inp["x"]))})
        dmesh = make_mesh((4,), ("data",))
        red = make_compressed_allreduce(dmesh, "data")(
            {"g": torch.from_numpy(inp["g"][RANK])})["g"]
        emit("compressed", red)
    """, 4, tmp_path)
    out, _ = jax_proc.communicate(timeout=240)
    assert jax_proc.returncode == 0, out
    jax_out = np.load(tmp_path / "jax_out.npz")
    for r in range(4):
        p = load(tmp_path, "pipeline", r)
        assert float((p["y"] - p["seq"]).abs().max()) < PIPELINE_ATOL
        assert np.max(np.abs(p["y"].numpy() - jax_out["pipeline"])) \
            < PIPELINE_ATOL
        red = load(tmp_path, "compressed", r).numpy()
        assert _rel(red, g.mean(0)) < COMPRESS_TOL_REL
        assert _rel(red, jax_out["compressed"].reshape(-1)) \
            < COMPRESS_VS_JAX_REL
        assert np.array_equal(red, load(tmp_path, "compressed", 0).numpy())


def test_train_driver_under_torchrun(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "samba-coe-expert-7b", "--reduced", "--device", "cpu",
         "--mesh", "1x2", "--steps", "5", "--batch", "4", "--seq", "32",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, timeout=240, env=env(), cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("step ") == 5 and " OK" in out.stdout
    assert (tmp_path / "ckpt" / "latest").read_text().strip() == \
        "step-000000005"
