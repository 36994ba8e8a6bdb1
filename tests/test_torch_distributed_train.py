"""Training on a mesh on the CPU, against the JAX package and the port's
single-device step: gloo groups of 2 and 4 ranks (``_torch_ranks``), the
counterparts of JAX's multi-device training tests
(``tests/test_distributed.py``):

  * reduced Mixtral (``pad_for_tp(..., 2)``, JAX's params through
    ``bridge``, in f32) on a (2, 2) mesh, three steps of
    ``make_train_step(mesh=...)`` (experts sharded over 'model', the MoE's
    dispatch on each rank through ``local_map``, Megatron-SP residuals),
    AdamW at 1e-3 after a 2-step warmup: the loss falls; each step's loss
    and grad norm, and every param after the third step (relative L2),
    within ``F32_TOL_REL`` of the single-device step's on the same params
    and batch, and the first step's loss and grad norm of JAX's
    single-device step's;
  * the elastic restart: three steps of reduced granite on a (1, 2) mesh,
    a checkpoint, a new group of 4 restoring it onto a (4, 1) mesh: every
    leaf of the state bit-equal to the (1, 2) state at the save, and three
    more steps on the same batch keep the loss falling.

JAX's EP-local MoE test has its counterpart in
``test_torch_distributed_steps.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import load, run_ranks, save
from repro.configs import get_config as jax_get_config
from repro.configs import pad_for_tp as jax_pad_for_tp
from repro.configs import reduced as jax_reduced
from repro.distributed import stepfn as jax_stepfn
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models import get_model as jax_get_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.bridge import to_torch, tree_items
from repro_torch.configs import get_config, pad_for_tp, reduced
from repro_torch.data import DataConfig, make_source
from repro_torch.distributed import stepfn
from repro_torch.optim import AdamWConfig

OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=4)
F32_TOL_REL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(cfg, seed=1):
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (4, 33), 0,
                                         cfg.vocab_size))
    return {"tokens": np.array(toks[:, :-1]),
            "targets": np.array(toks[:, 1:])}


def _jax_first_step(jcfg, jparams, batch):
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    with mesh:
        fn, sh, _ = jax_stepfn.make_train_step(jcfg, mesh,
                                               JaxAdamWConfig(**OPT))
        state = jax.device_put({"params": jparams,
                                "opt": jax_init_opt_state(jparams)}, sh)
        _, met = fn(state, jax.tree.map(jnp.asarray, batch))
    return float(met["loss"]), float(met["grad_norm"])


def _rel_l2(x, want):
    x, want = x.double(), want.double()
    return float(torch.linalg.vector_norm(x - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-30))


def test_train_step_on_2x2_mesh(tmp_path):
    jcfg = jax_pad_for_tp(jax_reduced(jax_get_config("mixtral-8x7b")), 2)
    cfg = pad_for_tp(reduced(get_config("mixtral-8x7b")), 2)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jax_get_model(jcfg).init(jax.random.PRNGKey(0)))
    batch = _batch(cfg)
    np_params = jax.tree.map(np.asarray, jparams)
    jl, jg = _jax_first_step(jcfg, jparams, batch)   # donates jparams
    params = to_torch(np_params)
    fn = stepfn.make_train_step(cfg, AdamWConfig(**OPT))
    state = stepfn.init_train_state(to_torch(np_params))
    single = []
    for _ in range(3):
        state, met = fn(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        single.append((float(met["loss"]), float(met["grad_norm"])))
    save(tmp_path, {"cfg": cfg, "params": params, "batch": batch,
                    "opt": AdamWConfig(**OPT)})
    run_ranks("""
        from repro_torch.bridge import tree_items
        from repro_torch.distributed import partitioning as part, stepfn
        from repro_torch.launch.mesh import make_mesh
        inp = torch.load(f"{TMP}/in.pt", weights_only=False)
        mesh = make_mesh((2, 2), ("data", "model"))
        fn, sh, bsh = stepfn.make_train_step(inp["cfg"], inp["opt"],
                                             mesh=mesh)
        state = part.device_put(stepfn.init_train_state(inp["params"]), sh)
        b = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
        b = part.device_put(b, bsh(b))
        out = []
        for _ in range(3):
            state, met = fn(state, b)
            out.append((float(met["loss"]), float(met["grad_norm"])))
        emit("metrics", out)
        emit("params", {n: x.full_tensor()
                        for n, x in tree_items(state["params"])})
    """, 4, tmp_path)
    runs = [load(tmp_path, "metrics", r) for r in range(4)]
    assert all(r == runs[0] for r in runs)       # every rank agrees
    assert runs[0][2][0] < runs[0][0][0], runs[0]
    for (l, g), (want_l, want_g) in zip(runs[0], single):
        assert abs(l - want_l) / abs(want_l) < F32_TOL_REL
        assert abs(g - want_g) / abs(want_g) < F32_TOL_REL
    got = load(tmp_path, "params")
    want = dict(tree_items(state["params"]))
    assert set(got) == set(want)
    errs = {n: _rel_l2(got[n], want[n]) for n in want}
    assert max(errs.values()) < F32_TOL_REL, errs
    l0, g0 = runs[0][0]
    assert abs(l0 - jl) / abs(jl) < F32_TOL_REL
    assert abs(g0 - jg) / abs(jg) < F32_TOL_REL


def test_elastic_restart_across_meshes(tmp_path):
    cfg = pad_for_tp(reduced(get_config("granite-8b")), 2)
    src = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                 global_batch=4))
    save(tmp_path, {"cfg": cfg, "batch": src.batch_at(0),
                    "ckpt": str(tmp_path / "ckpt")})
    prelude = """
        from repro_torch.bridge import tree_items
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.distributed import partitioning as part, stepfn
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import get_model
        inp = torch.load(f"{TMP}/in.pt", weights_only=False)
        cfg = inp["cfg"]
        b = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}

        def full(state):
            return {n: x.full_tensor() for n, x in tree_items(state["params"])
                    } | {"mu/" + n: x.full_tensor()
                         for n, x in tree_items(state["opt"]["mu"])}
    """
    run_ranks(prelude + """
        mesh = make_mesh((1, 2), ("data", "model"))
        fn, sh, bsh = stepfn.make_train_step(cfg, mesh=mesh)
        params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        state = part.device_put(stepfn.init_train_state(params), sh)
        for _ in range(3):
            state, met = fn(state, part.device_put(b, bsh(b)))
        CheckpointManager(inp["ckpt"]).save(3, state)
        emit("saved", {"loss": float(met["loss"]), "state": full(state)})
    """, 2, tmp_path)
    run_ranks(prelude + """
        mesh = make_mesh((4, 1), ("data", "model"))
        fn, sh, bsh = stepfn.make_train_step(cfg, mesh=mesh)
        like = part.device_put(stepfn.init_train_state(get_model(cfg).init(
            torch.Generator().manual_seed(1), "cpu")), sh)
        state, start = CheckpointManager(inp["ckpt"]).restore_state(
            like, shardings=sh)
        emit("restored", {"start": start, "state": full(state),
                          "placements": str(state["params"]["lm_head"]
                                            .placements)})
        for _ in range(3):
            state, met = fn(state, part.device_put(b, bsh(b)))
        emit("resumed", float(met["loss"]))
    """, 4, tmp_path)
    saved = load(tmp_path, "saved")
    for r in range(4):
        restored = load(tmp_path, "restored", r)
        assert restored["start"] == 3
        assert "Shard(dim=0)" not in restored["placements"]   # (4, 1) mesh
        assert set(restored["state"]) == set(saved["state"])
        for n, x in saved["state"].items():
            y = restored["state"][n]
            assert x.dtype == y.dtype and torch.equal(
                x.view(-1).view(torch.uint8), y.view(-1).view(torch.uint8)), n
        assert load(tmp_path, "resumed", r) < saved["loss"]
