"""The port's partitioning rules and the pure parts of distribution against
the JAX package, in-process (no group):

  * ``param_pspecs``, ``cache_pspecs`` (with and without
    ``cache_seq_shard``), ``cache_layer_pspecs``, ``paged_pool_pspec``,
    ``batch_pspecs`` and ``fit_pspec`` / ``fit_pspec_tree`` equal JAX's,
    as tuples, for every arch on the fake (2, 16, 16) production mesh of
    JAX's ``test_param_pspecs_divisibility`` and on a (2, 2) mesh;
  * ``leaf_shard_dim`` (the node's form) agrees with ``leaf_pspec`` on a
    ``('model',)`` mesh;
  * ``placements`` lays a spec onto a mesh's axes;
  * ``quantize_int8`` / ``dequantize_int8`` / ``error_feedback_update``
    are bit-equal to JAX's on the same numpy inputs;
  * ``PerfOptions`` has JAX's fields and defaults, and the fields the port
    does not read are refused."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import pad_for_tp as jax_pad_for_tp
from repro.distributed import compression as JC
from repro.distributed import ctx as jctx
from repro.distributed import partitioning as jpart
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config, pad_for_tp
from repro_torch.distributed import compression as C
from repro_torch.distributed import ctx
from repro_torch.distributed import partitioning as part
from repro_torch.models import get_model


class _Mesh:
    """A mesh with JAX's ``axis_names`` / ``shape`` (no devices)."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {"2x16x16": (_Mesh(pod=2, data=16, model=16), 16),
          "2x2": (_Mesh(data=2, model=2), 2)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _tuples(tree):
    return {k: tuple(v) for k, v in _flat(tree).items()}


def _configs(arch, tp):
    return (jax_pad_for_tp(jax_get_config(arch), tp),
            pad_for_tp(get_config(arch), tp))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_specs_equal_jax(arch, mesh_name):
    mesh, tp = MESHES[mesh_name]
    jcfg, cfg = _configs(arch, tp)
    got = _tuples(part.param_pspecs(get_model(cfg).param_specs(), mesh))
    want = _tuples(jpart.param_pspecs(jax_get_model(jcfg).param_specs(),
                                      mesh))
    assert got == want
    # every sharded dim divides its axes (JAX's divisibility test)
    specs = _flat(get_model(cfg).param_specs())
    for k, p in got.items():
        for dim, entry in zip(specs[k].shape, p):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                assert dim % int(np.prod([mesh.shape[a] for a in axes])) == 0
    for seq_shard in (False, True):
        with ctx.perf_options(ctx.PerfOptions(cache_seq_shard=seq_shard)), \
                jctx.perf_options(jctx.PerfOptions(
                    cache_seq_shard=seq_shard)):
            assert _tuples(part.cache_pspecs(cfg, mesh)) == \
                _tuples(jpart.cache_pspecs(jcfg, mesh))
            assert _tuples(part.cache_layer_pspecs(cfg, mesh)) == \
                _tuples(jpart.cache_layer_pspecs(jcfg, mesh))
    assert tuple(part.paged_pool_pspec(cfg, mesh)) == \
        tuple(jpart.paged_pool_pspec(jcfg, mesh))
    batch = {"tokens": np.zeros((4, 8)), "targets": np.zeros((4, 8)),
             "enc_embeds": np.zeros((4, 8, 16))}
    assert _tuples(part.batch_pspecs(cfg, batch, mesh)) == \
        _tuples(jpart.batch_pspecs(jcfg, batch, mesh))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_fit_pspec_tree_equal_jax(arch, mesh_name):
    """The cache specs fitted to a cache of batch 1, 2 and 32 (batch 1 drops
    the data axes) equal JAX's."""
    mesh, tp = MESHES[mesh_name]
    jcfg, cfg = _configs(arch, tp)
    for batch in (1, 2, 32):
        cs = get_model(cfg).cache_spec(batch, 64)
        jcs = jax_get_model(jcfg).cache_spec(batch, 64)
        got = part.fit_pspec_tree(cs, part.cache_pspecs(cfg, mesh), mesh)
        want = jpart.fit_pspec_tree(jcs, jpart.cache_pspecs(jcfg, mesh),
                                    mesh)
        assert _tuples(got) == _tuples(want), batch


def test_fit_pspec_drops_undivisible():
    mesh = _Mesh(data=16, model=16)
    for shape, spec in (((1, 100, 32), ("data", None, "model")),
                        ((32, 16), (("pod", "data"), "model")),
                        ((8,), ("data", "model")),
                        ((16, 4, 2), (None,))):
        m = _Mesh(pod=2, data=16, model=16) if "pod" in str(spec) else mesh
        assert tuple(part.fit_pspec(shape, part.P(*spec), m)) == \
            tuple(jpart.fit_pspec(shape, jax.sharding.PartitionSpec(*spec),
                                  m))
    assert part.fit_pspec((1, 100, 32), part.P("data", None, "model"),
                          mesh) == part.P(None, None, "model")


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_leaf_shard_dim_agrees_with_leaf_pspec(arch):
    for tp in (2, 4, 16):
        cfg = pad_for_tp(get_config(arch), tp)
        mesh = _Mesh(model=tp)
        for k, s in _flat(get_model(cfg).param_specs()).items():
            p = tuple(part.leaf_pspec(s, mesh))
            want = p.index("model") if "model" in p else None
            assert part.leaf_shard_dim(s, tp) == want, (k, tp)


def test_placements_lay_a_spec_onto_the_mesh():
    from torch.distributed.tensor import Replicate, Shard

    class M:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 4)

    assert part.placements(part.P(("pod", "data"), None, "model"), M()) == \
        (Shard(0), Shard(0), Shard(2))
    assert part.placements(part.P(None, "data"), M()) == \
        (Replicate(), Shard(1), Replicate())
    assert part.placements(part.P(), M()) == (Replicate(),) * 3
    M.shape = (1, 2, 1)              # a size-1 axis replicates
    assert part.placements(part.P(("pod", "data"), None, "model"), M()) == \
        (Replicate(), Shard(0), Replicate())


def test_int8_quantization_bit_equal_jax():
    rng = np.random.RandomState(0)
    for x in (rng.randn(64).astype(np.float32),
              (rng.randn(4, 33) * 1e-3).astype(np.float32),
              np.zeros(5, np.float32)):
        q, s = C.quantize_int8(torch.from_numpy(x))
        jq, js = JC.quantize_int8(jnp.asarray(x))
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        d = C.dequantize_int8(q, s)
        assert d.numpy().tobytes() == \
            np.asarray(JC.dequantize_int8(jq, js)).tobytes()


def test_error_feedback_bit_equal_jax_and_converges():
    true = (np.random.RandomState(0).randn(32) * 0.01).astype(np.float32)
    resid, jresid = torch.zeros(32), jnp.zeros(32)
    acc = torch.zeros(32)
    for _ in range(50):
        v, resid = C.error_feedback_update(torch.from_numpy(true), resid)
        jv, jresid = JC.error_feedback_update(jnp.asarray(true), jresid)
        assert v.numpy().tobytes() == np.asarray(jv).tobytes()
        assert resid.numpy().tobytes() == np.asarray(jresid).tobytes()
        acc += v
    np.testing.assert_allclose((acc / 50).numpy(), true, atol=1e-3)


def test_perf_options_are_jax_s():
    got = {f.name: f.default for f in dataclasses.fields(ctx.PerfOptions)}
    want = {f.name: f.default for f in dataclasses.fields(jctx.PerfOptions)}
    assert got == want
    assert ctx.perf() == ctx.PerfOptions()
    with ctx.perf_options(ctx.PerfOptions(capacity_factor=2.0,
                                          moe_ep_local=True)):
        assert ctx.perf().capacity_factor == 2.0
    assert ctx.perf() == ctx.PerfOptions()
    # every field a JAX module reads is read: only chunked_loss, which none
    # reads, is refused
    assert ctx.UNREAD == ("chunked_loss",)
    for name in ctx.UNREAD:
        with pytest.raises(NotImplementedError, match=name):
            with ctx.perf_options(ctx.PerfOptions(**{name: True})):
                pass
    for name in ("mlstm_bf16", "decode_cache_carry",
                 "moe_dispatch_constraint"):
        with ctx.perf_options(ctx.PerfOptions(**{name: True})):
            assert getattr(ctx.perf(), name) is True
    assert ctx.perf() == ctx.PerfOptions()


def test_constraints_are_the_identity_off_a_mesh():
    """Off a mesh (plain tensors) every constraint returns its input, so the
    single-device paths keep their bits."""
    h = torch.randn(2, 4, 8)
    with ctx.activation_sharding(part.P("data", "model", None)), \
            ctx.named_shardings(cache_kv=part.P(None, "data")):
        assert ctx.constrain(h) is h
        assert ctx.constrain_named("cache_kv", h) is h
    assert ctx.cache_zeros("k", (2, 3), torch.bfloat16, "cpu").dtype == \
        torch.bfloat16
