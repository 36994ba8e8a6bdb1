"""The multi-socket node of the port against the JAX package:

  * the pure parts equal JAX's on seeded inputs: ``plan_expert_placement``,
    the ``bandwidth_model`` functions over every ``MACHINES`` preset,
    ``pad_for_tp`` and the partitioning rules (the dim each leaf and the
    paged pool shard on, against JAX's ``PartitionSpec``s); the topology's
    validation;
  * the TP = 2 and TP = 4 paged extend (the plain TP body at g 1 and 3, the
    fused TP body at g 1 through the kernels' plain versions; kv heads
    sharded and, at TP 4 with 2 kv heads, replicated) against JAX's
    single-device ``xla_paged_extend`` on the same f32 weights, pool and
    tokens: logits of the active lanes within 1e-4 of the largest logit,
    the pool within 1e-5 (its head-sharded storage read back in the
    full-head layout) at every row but the scratch row;
  * a reduced f32 2 x 2 node drain gives greedy tokens identical to JAX's
    single-device ``ServingEngine`` on the same trace (JAX's own node is
    not the reference: its 2 x 4 test is red), with packed and sequential
    prefill, inside each group's HBM budget, no KV leaked;
  * a disaggregated drain (one prefill group) gives tokens identical to
    the colocated node's, and its decode groups run no prefill forward;
  * least-loaded dispatch and ``rebalance`` behave as JAX's test of them
    asserts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import pad_for_tp as jax_pad_for_tp
from repro.configs import reduced as jax_reduced
from repro.core import bandwidth_model as JBW
from repro.core import memory_tiers as JMT
from repro.models import get_model as jax_get_model
from repro.node.placement import ExpertProfile as JaxProfile
from repro.node.placement import plan_expert_placement as jax_plan
from repro.serving import backends as JB
from repro_torch.bridge import to_torch, tree_map
from repro_torch.configs import get_config, pad_for_tp, reduced
from repro_torch.core import HashRouter
from repro_torch.core import bandwidth_model as BW
from repro_torch.core import memory_tiers as MT
from repro_torch.node import (ExpertProfile, RDUNode, TPPagedDecodeRunner,
                              ensure_emulated_sockets, make_node_topology,
                              plan_expert_placement)
from repro_torch.serving import FusedPagedBackend, Request, XlaPagedBackend

LOGIT_TOL_REL = 1e-4
POOL_ATOL = 1e-5
ENGINE = dict(max_len=48, n_slots=4, block_size=8)
# expert of each request (None: routed by the hash router at submit)
EXPERT_OF = [0, 1, 0, 2, None, 1, 0, None, 2, 1, None, 0]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sockets(n):
    return ensure_emulated_sockets(n, "cpu")


# ------------------------------------------------------------ pure parts
def test_placement_and_bandwidth_model_equal_jax():
    rs = np.random.RandomState(0)
    for trial in range(60):
        n, g = rs.randint(1, 9), rs.randint(1, 5)
        sizes = rs.randint(50, 400, n) * 10 ** 6
        demand = rs.choice([0.0, 1.0, 3.0, 20.0], n) * (trial % 5 != 0)
        budgets = list(rs.randint(0, 1200, g) * 10 ** 6)
        kw = dict(tp=int(rs.choice([1, 2, 4])),
                  avg_tokens=int(rs.randint(1, 64)),
                  replicate_share=float(rs.choice([0.25, 0.5, 1.0])))
        name = rs.choice(sorted(MT.MACHINES))
        got = plan_expert_placement(
            [ExpertProfile(f"e{i}", int(s), float(d))
             for i, (s, d) in enumerate(zip(sizes, demand))], budgets,
            machine=MT.MACHINES[name], **kw)
        want = jax_plan(
            [JaxProfile(f"e{i}", int(s), float(d))
             for i, (s, d) in enumerate(zip(sizes, demand))], budgets,
            machine=JMT.MACHINES[name], **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), trial
    assert MT.MACHINES.keys() == JMT.MACHINES.keys()
    for name, m in MT.MACHINES.items():
        jm = JMT.MACHINES[name]
        assert dataclasses.asdict(m) == dataclasses.asdict(jm)
        for nb in (10 ** 8, 13_476_831_232):
            assert BW.switch_cost(nb, m) == JBW.switch_cost(nb, jm)
            for res in (True, False):
                assert (BW.expert_service_cost(nb, 3.0, m, tp=2,
                                               avg_tokens=7, resident=res)
                        == JBW.expert_service_cost(nb, 3.0, jm, tp=2,
                                                   avg_tokens=7,
                                                   resident=res))
            c, jc = (f(nb // 2, 4096, 8, mm, tp=4, collective_bytes=1e6)
                     for f, mm in ((BW.decode_step_cost, m),
                                   (JBW.decode_step_cost, jm)))
            assert (c.step_s, c.bottleneck) == (jc.step_s, jc.bottleneck)
            assert (BW.coe_latency(5, nb, 2, c, 16, m)
                    == JBW.coe_latency(5, nb, 2, jc, 16, jm))
            for cap in (True, False):
                assert (BW.footprint_nodes(150, nb, m, cap)
                        == JBW.footprint_nodes(150, nb, jm, cap))


def test_topology_validation_and_partitioning_rules():
    from jax.sharding import PartitionSpec as P

    from repro.distributed.partitioning import leaf_pspec, paged_pool_pspec
    from repro.models.common import ParamSpec as JaxSpec
    from repro_torch.distributed.partitioning import (paged_pool_shard_dim,
                                                      param_shard_dims)
    from repro_torch.models import get_model

    def flat(tree, prefix=""):
        if not isinstance(tree, dict):
            return {prefix: tree}
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    with pytest.raises(ValueError):
        make_node_topology(0, devices=_sockets(1))
    with pytest.raises(ValueError, match="ensure_emulated_sockets"):
        make_node_topology(4, 4, devices=_sockets(1))
    with pytest.raises(ValueError):
        make_node_topology(2, 0, devices=_sockets(2))
    topo = make_node_topology(2, devices=_sockets(8))
    assert topo.name == "2x4" and topo.n_sockets == 8
    assert [g.tp for g in topo.groups] == [2] * 4
    assert [len(g.devices) for g in topo.groups] == [2] * 4
    assert topo.groups[1].device == torch.device("cpu")

    class Mesh:
        axis_names = ("model",)

        def __init__(self, n):
            self.shape = {"model": n}

    for arch in ("samba-coe-expert-7b",):
        for tp in (1, 2, 4, 8):
            for red in (True, False):
                cfg, jcfg = get_config(arch), jax_get_config(arch)
                if red:
                    cfg, jcfg = reduced(cfg), jax_reduced(jcfg)
                cfg, jcfg = pad_for_tp(cfg, tp), jax_pad_for_tp(jcfg, tp)
                for f in ("n_heads", "n_kv_heads", "vocab_size",
                          "orig_n_heads", "orig_n_kv_heads",
                          "orig_vocab_size"):
                    assert getattr(cfg, f) == getattr(jcfg, f), (tp, f)
                dims = flat(param_shard_dims(get_model(cfg).param_specs(),
                                             tp))
                jspecs = jax.tree_util.tree_flatten_with_path(
                    jax_get_model(jcfg).param_specs(),
                    is_leaf=lambda x: isinstance(x, JaxSpec))[0]
                for path, s in jspecs:
                    key = "/".join(str(p.key) for p in path)
                    ps = leaf_pspec(s, Mesh(tp))
                    want = (list(ps).index("model") if "model" in ps
                            else None)
                    assert dims[key] == want, (tp, key)
                jp = paged_pool_pspec(jcfg, Mesh(tp))
                assert paged_pool_shard_dim(cfg, tp) == (
                    3 if jp == P(None, None, None, "model", None) else None)
    small = dataclasses.replace(reduced(get_config("samba-coe-expert-7b")),
                                n_kv_heads=2)
    assert paged_pool_shard_dim(small, 2) == 3
    assert paged_pool_shard_dim(small, 4) is None      # kv 2 < 4: replicate


# ------------------------------------------------------- TP paged extend
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
    """The numpy pool as the group holds it: rank-major storage, 6-D view
    (``PagedKVCache.shard_heads``), or as is where the kv replicate."""
    t = torch.tensor(x)
    if not kv_sharded:
        return t
    L, rows, blk, H, dh = t.shape
    return t.reshape(L, rows, blk, tp, H // tp, dh).permute(
        3, 0, 1, 2, 4, 5).contiguous().permute(1, 2, 3, 0, 4, 5)


def test_tp_extend_matches_jax_single_device():
    for tp, kv, g, backend in ((2, 4, 1, FusedPagedBackend),
                               (2, 4, 3, XlaPagedBackend),
                               (2, 4, 1, XlaPagedBackend),
                               (4, 2, 1, XlaPagedBackend),
                               (4, 2, 3, XlaPagedBackend)):
        jcfg = dataclasses.replace(
            jax_reduced(jax_get_config("samba-coe-expert-7b")), n_layers=2,
            n_kv_heads=kv)
        cfg = dataclasses.replace(reduced(get_config("samba-coe-expert-7b")),
                                  n_layers=2, n_kv_heads=kv)
        params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                              jax_get_model(jcfg).init(
                                  jax.random.PRNGKey(tp + kv)))
        pk, pv, tables, lengths, active, tokens, scratch = _state(
            cfg, g, seed=tp * 10 + g)
        jl, jk, jv = (np.asarray(x) for x in JB.xla_paged_extend(
            jcfg, params, jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(active),
            jnp.asarray(tokens), scratch))
        runner = TPPagedDecodeRunner(cfg, scratch, _sockets(tp),
                                     backend=backend(cfg))
        assert runner.kv_sharded == (kv % tp == 0)
        ranks = runner.place_params(to_torch(params))
        k6 = _sharded_pool(pk, tp, runner.kv_sharded)
        v6 = _sharded_pool(pv, tp, runner.kv_sharded)
        logits, k, v = runner.extend(
            ranks, k6, v6, torch.as_tensor(tables), torch.as_tensor(lengths),
            torch.as_tensor(active), torch.as_tensor(tokens).long())
        label = f"tp={tp} kv={kv} g={g} {backend.__name__}"
        tol = LOGIT_TOL_REL * float(np.abs(jl[active]).max())
        np.testing.assert_allclose(logits.numpy()[active], jl[active],
                                   atol=tol, rtol=0, err_msg=label)
        k, v = (t.reshape(pk.shape).numpy() for t in (k, v))
        np.testing.assert_allclose(k[:, :scratch], jk[:, :scratch],
                                   atol=POOL_ATOL, rtol=0, err_msg=label)
        np.testing.assert_allclose(v[:, :scratch], jv[:, :scratch],
                                   atol=POOL_ATOL, rtol=0, err_msg=label)
    with pytest.raises(ValueError, match="head-sharded"):
        TPPagedDecodeRunner(cfg, 0, _sockets(4))       # fused, kv 2 < 4


# -------------------------------------------------------- whole node
@pytest.fixture(scope="module")
def experts():
    jcfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    m = jax_get_model(jcfg)
    trees = [jax.tree.map(lambda x: np.asarray(x, np.float32),
                          m.init(jax.random.fold_in(jax.random.PRNGKey(5),
                                                    i)))
             for i in range(3)]
    nbytes = sum(x.nbytes for x in jax.tree.leaves(trees[0]))
    return jcfg, reduced(get_config("samba-coe-expert-7b")), trees, nbytes


def _requests(cls, vocab):
    rs = np.random.RandomState(11)
    return [cls(rid=i, tokens=rs.randint(0, vocab, (3 + 4 * (i % 4),))
                .astype(np.int32), max_new_tokens=2 + i % 5,
                expert=None if e is None else f"e{e}")
            for i, e in enumerate(EXPERT_OF)]


@pytest.fixture(scope="module")
def jax_streams(experts):
    """JAX's single-device engine on the trace: the reference streams."""
    from repro.core import CompositionOfExperts as JaxCoE
    from repro.core import ExpertHandle as JaxHandle
    from repro.core import HashRouter as JaxHashRouter
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
    jcfg, _, trees, nbytes = experts
    coe = JaxCoE(JaxHashRouter(3), None, int(3 * nbytes))
    for i, t in enumerate(trees):
        coe.register(JaxHandle(f"e{i}", jcfg, t))
    eng = JaxEngine(coe, jcfg, backend="xla", kv_dtype=jnp.float32, **ENGINE)
    for r in _requests(JaxRequest, jcfg.vocab_size):
        eng.submit(r)
    done = eng.drain()
    coe.cache.close()
    return {r.rid: (r.expert, r.output) for r in done}


def _node(experts, topo, prefill_groups=0, **kw):
    _, cfg, trees, nbytes = experts
    node = RDUNode(topo, cfg, HashRouter(3), None,
                   group_hbm_bytes=int(1.5 * nbytes),
                   group_kv_reserve_bytes=int(0.4 * nbytes),
                   kv_dtype=torch.float32, prefill_groups=prefill_groups,
                   **ENGINE, **kw)
    for i, t in enumerate(trees):
        node.register_expert(f"e{i}", to_torch(t))
    return node


def _drain(node, cfg, check_budget=True):
    for r in _requests(Request, cfg.vocab_size):
        node.submit(r)
    done = []
    while node.has_work:
        done.extend(node.step())
        assert not check_budget or node.hbm_within_budget()
    return {r.rid: (r.expert, r.output) for r in done}


def test_node_2x2_drain_matches_jax_single_device_engine(experts,
                                                        jax_streams):
    _, cfg, _, nbytes = experts
    for kw in ({}, {"prefill_mode": "sequential",
                    "scheduler": "run_to_completion"},
               {"backend": XlaPagedBackend(cfg)}):
        node = _node(experts, make_node_topology(2, 2, _sockets(4)), **kw)
        got = _drain(node, cfg)
        assert got.keys() == jax_streams.keys() == set(range(len(EXPERT_OF)))
        for rid, (expert, out) in jax_streams.items():
            assert got[rid][0] == expert
            np.testing.assert_array_equal(got[rid][1], out,
                                          err_msg=f"{kw} {rid}")
        st = node.stats()
        assert st.requests == len(EXPERT_OF)
        assert all(g["requests"] for g in st.per_group)   # both groups
        assert node.placement.spilled                     # 3 experts, 2 slots
        for gs in node.groups:
            assert gs.engine.pool.stats.blocks_in_use == 0
            assert gs.engine.pool.check_invariants() == []
            assert gs.engine.pool.head_shards == 2
            assert gs.coe.cache.used_bytes <= gs.coe.cache.capacity
        node.close()


def test_disaggregated_drain_matches_colocated(experts, monkeypatch):
    _, cfg, _, _ = experts
    co = _drain(_node(experts, make_node_topology(2, 2, _sockets(4))), cfg)
    node = _node(experts, make_node_topology(2, 3, _sockets(6)),
                 prefill_groups=1)
    for gs in node.groups:                  # decode groups never prefill
        def refuse(*a, **k):
            raise AssertionError("a decode group ran a prefill forward")
        monkeypatch.setattr(gs.engine.prefill_runner, "_fn", refuse)
        monkeypatch.setattr(gs.engine.runner, "prefill_kv", refuse)
    dis = _drain(node, cfg)
    assert dis.keys() == co.keys()
    for rid in co:
        assert dis[rid][0] == co[rid][0]
        np.testing.assert_array_equal(dis[rid][1], co[rid][1], str(rid))
    st = node.stats()
    assert [g["prefilled"] for g in st.prefill_groups] == [len(EXPERT_OF)]
    assert [g["gid"] for g in st.per_group] == [1, 2]
    handoffs = sum(m.value for m in node.registry.metrics()
                   if m.name == "node.kv_handoffs")
    assert handoffs == len(EXPERT_OF)
    assert node.workers[0].pool.stats.blocks_in_use == 0
    with pytest.raises(ValueError, match="decode group"):
        _node(experts, make_node_topology(2, 1, _sockets(2)),
              prefill_groups=1)
    node.close()


def test_dispatch_least_loaded_and_rebalance(experts):
    """JAX's ``test_dispatch_least_loaded_and_rebalance`` on the port: the
    requests of one expert spread over its replica groups; rebalancing from
    observed demand replans and prewarms; budgets hold."""
    _, cfg, trees, nbytes = experts
    node = RDUNode(make_node_topology(2, 4, _sockets(8)), cfg, HashRouter(2),
                   None, group_hbm_bytes=int(2.5 * nbytes),
                   group_kv_reserve_bytes=int(0.8 * nbytes), n_slots=2,
                   block_size=8, max_len=16, replicate_share=0.25,
                   kv_dtype=torch.float32)
    host = to_torch(trees[0])
    node.register_expert("e0", host)
    node.register_expert("e1", tree_map(torch.clone, host))
    rs = np.random.RandomState(2)
    gids = [node.submit(Request(
        rid=i, tokens=rs.randint(0, cfg.vocab_size, (6,)).astype(np.int32),
        max_new_tokens=2, expert="e0")) for i in range(6)]
    owners = set(node.placement.owners("e0"))
    assert set(gids) <= owners and len(owners) > 1
    assert len(set(gids)) > 1                      # the load spreads
    node.drain()
    pl = node.rebalance()
    assert len(pl.owners("e0")) >= len(pl.owners("e1"))
    assert any(gs.coe.cache.inflight(n) or gs.coe.cache.resident(n)
               for gs in node.groups for n in pl.resident[gs.group.gid])
    assert node.hbm_within_budget()
    st = node.stats()
    assert st.requests == 6 and st.tokens_out == 12
    assert sum(g["submitted"] for g in st.per_group) == 6
    assert node.debug_placement()["planned"]
    assert "g0.slots" in node.debug_providers()
    # session affinity: a session's later turns land on its first group
    gid = node.submit(Request(rid=50, tokens=np.arange(4, dtype=np.int32),
                              max_new_tokens=1, expert="e1", session_id="s"))
    for rid in (51, 52):
        assert node.submit(Request(
            rid=rid, tokens=np.arange(4, dtype=np.int32), max_new_tokens=1,
            expert="e1", session_id="s")) == gid
    node.drain()
    node.close()
