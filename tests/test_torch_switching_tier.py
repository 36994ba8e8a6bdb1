"""The weight cache's books on the expert tier: the same sequence of
``activate`` (read-only and mutable), ``prefetch``, ``mark_dirty``,
evictions and ``drop`` runs on the port's ``HBMWeightCache`` and on the JAX
package's, over the same trees in each package's host, mmap and int8
stores, and through ``fetch=`` and ``writeback=``. After every operation
the integer ``SwitchStats`` fields, the transfer ledger's bytes and
transfer counts per (edge, cause), the resident set and the bytes in use
must be equal; the JAX prefetch runs on its executor, so the driver waits
for it before the next operation. Write-back must hand back exactly the
bytes the caller left in the entry. Also the cache's placement callable
(``sharding=`` / ``gather=``) with the TP runner's ``place_params``. Every
comparison is exact."""
import jax
import numpy as np
import pytest
import torch

from repro.core.switching import HBMWeightCache as JaxCache
from repro.store import make_store as jax_make_store
from repro_torch.bridge import tree_map, to_numpy, to_torch
from repro_torch.core import HBMWeightCache
from repro_torch.store import make_store

N_EXPERTS = 4
INT_FIELDS = ("hits", "misses", "prefetch_hits", "prefetch_failures",
              "prefetches_issued", "prefetches_cancelled", "evictions",
              "drops", "bytes_copied_in", "bytes_copied_back",
              "bytes_copyback_elided")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _trees():
    rs = np.random.RandomState(0)
    return {f"e{i}": {"w": rs.standard_normal((24, 40)).astype(np.float32),
                      "b": rs.standard_normal((40,)).astype(np.float32),
                      "state": np.zeros((16,), np.float32)}
            for i in range(N_EXPERTS)}


def _books(cache):
    st = cache.stats.as_dict()
    reg = {}
    for m in cache.ledger.registry.metrics():
        if m.name in ("ledger.transfers", "ledger.bytes"):
            reg[(m.name, tuple(sorted(dict(m.labels).items())))] = m.value
    return ({k: st[k] for k in INT_FIELDS}, reg,
            cache.ledger.reserved_bytes, sorted(cache._entries),
            cache.used_bytes)


class _Pair:
    """One operation on both caches, books compared after it."""

    def __init__(self, port, jax_cache):
        self.p, self.j = port, jax_cache

    def _settle(self):
        for fut in list(self.j._inflight.values()):
            try:
                fut.result()
            except Exception:
                pass

    def __call__(self, op, name, **kw):
        rp = getattr(self.p, op)(name, **kw)
        rj = getattr(self.j, op)(name, **kw)
        self._settle()
        if op == "activate":
            for k in rj:
                np.testing.assert_array_equal(rp[k].numpy(),
                                              np.asarray(rj[k]))
        else:
            assert rp == rj, (op, name)
        assert _books(self.p) == _books(self.j), (op, name)
        return rp, rj


def _script(pair):
    """activate / prefetch / mark_dirty / evict / drop, with a mutable
    entry written in both packages the same way before it is retired."""
    pair("activate", "e0")
    pair("activate", "e1", read_only=False)
    rp, rj = pair("activate", "e1")                    # a hit
    pair("prefetch", "e2")                             # evicts e0 (read-only)
    rp, _ = pair("activate", "e1", read_only=False)
    rp["state"].add_(1.5)
    pair.j._entries["e1"].value = {
        **pair.j._entries["e1"].value,
        "state": pair.j._entries["e1"].value["state"] + 1.5}
    pair("mark_dirty", "e1")
    pair("activate", "e2")                             # consumes the prefetch
    pair("prefetch", "e3")                             # evicts dirty e1
    pair("drop", "e3")                                 # cancels in flight
    pair("activate", "e0", read_only=False)
    pair("mark_dirty", "e0")
    pair("drop", "e0")                                 # dirty drop
    pair("drop", "e2")                                 # read-only drop
    pair("drop", "e1")                                 # not resident: no-op


@pytest.mark.parametrize("kind", ["host", "mmap", "int8"])
def test_cache_books_equal_jax_on_every_store(tmp_path, kind):
    trees = _trees()
    spec = {"host": "host", "int8": "int8:8"}.get(kind)
    ps = make_store(spec or f"mmap:{tmp_path / 'port'}")
    js = jax_make_store(spec or f"mmap:{tmp_path / 'jax'}")
    for name, t in trees.items():
        ps.put(name, to_torch(t))
        js.put(name, t)
    nbytes = ps.nbytes("e0")
    cap = 2 * nbytes
    pair = _Pair(HBMWeightCache(cap, ps, "cpu"),
                 JaxCache(cap, store=js, device=jax.devices("cpu")[0]))
    _script(pair)
    st = pair.p.stats
    assert st.drops == 2 and st.bytes_copied_back == 2 * nbytes
    assert pair.p.ledger.bytes_moved("writeback") == 2 * nbytes
    # the written-back state reads back through the store, as JAX's does
    for name in ("e0", "e1"):
        np.testing.assert_array_equal(to_numpy(ps.get(name)["state"]),
                                      np.asarray(js.get(name)["state"]))
    if kind != "int8":                       # int8 round-trips lossily
        np.testing.assert_array_equal(to_numpy(ps.get("e1")["state"]),
                                      trees["e1"]["state"] + 1.5)
    pair.p.close()
    pair.j.close()


def test_fetch_and_writeback_callables_match_jax():
    """``fetch=``: no reservation for a prefetch (the callable cannot size
    an expert without reading it), the load still lands; ``writeback=``
    receives the dirty entry's exact bytes on eviction."""
    trees = _trees()
    pt = {k: to_torch(v) for k, v in trees.items()}
    got_p, got_j = {}, {}
    cap = 2 * sum(x.nbytes for x in trees["e0"].values())
    p = HBMWeightCache(cap, device="cpu", fetch=lambda n: pt[n],
                       writeback=lambda n, t: got_p.setdefault(n, t))
    j = JaxCache(cap, fetch=lambda n: trees[n],
                 writeback=lambda n, t: got_j.setdefault(n, t),
                 device=jax.devices("cpu")[0])
    assert p.store.cheap_nbytes is j.store.cheap_nbytes is False
    pair = _Pair(p, j)
    pair("prefetch", "e0")
    assert p.ledger.reserved_bytes == 0
    rp, _ = pair("activate", "e0", read_only=False)
    rp["b"].mul_(2.0)
    j._entries["e0"].value = {**j._entries["e0"].value,
                              "b": j._entries["e0"].value["b"] * 2.0}
    pair("mark_dirty", "e0")
    for name in ("e1", "e2"):
        pair("activate", name)               # the second evicts e0
    assert set(got_p) == set(got_j) == {"e0"}
    for k in trees["e0"]:
        np.testing.assert_array_equal(got_p["e0"][k].numpy(),
                                      np.asarray(got_j["e0"][k]))
    np.testing.assert_array_equal(got_p["e0"]["b"].numpy(),
                                  trees["e0"]["b"] * 2.0)
    assert p.expert_ids() == j.expert_ids() == ["e1", "e2"]
    with pytest.raises(ValueError):
        HBMWeightCache(1, device="cpu")
    p.close()
    j.close()


def test_placement_callable_installs_rank_shards_and_gathers_back():
    """``sharding=`` is the group's placement: the cache installs what it
    returns (one tree of shards a rank) and accounts the host tree's bytes;
    a dirty placed entry is written back through ``gather=`` as the
    host-layout tree."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.node import TPPagedDecodeRunner
    from repro_torch.serving import XlaPagedBackend
    from repro_torch.store import HostMemoryStore
    cfg = reduced(get_config("samba-coe-expert-7b"))
    host = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    runner = TPPagedDecodeRunner(cfg, 0, ("cpu", "cpu"),
                                 backend=XlaPagedBackend(cfg))
    store = HostMemoryStore()
    store.put("e0", host)
    cache = HBMWeightCache(10 ** 9, store, "cpu",
                           sharding=runner.place_params,
                           gather=runner.gather_params)
    ranks = cache.activate("e0", read_only=False)
    assert len(ranks) == 2
    wq = host["layers"]["attn"]["wq"]                    # (L, D, Hq, dh)
    half = wq.shape[2] // 2
    assert torch.equal(ranks[1]["layers"]["attn"]["wq"], wq[:, :, half:])
    assert ranks[1]["layers"]["attn"]["wq"].is_contiguous()
    # the vocab (512) shards over two ranks; the norms replicate
    assert ranks[0]["embed"]["tok"].shape[0] == cfg.vocab_size // 2
    assert ranks[0]["final_norm"]["scale"] is ranks[1]["final_norm"]["scale"]
    assert cache.used_bytes == store.nbytes("e0")
    ranks[0]["layers"]["mlp"]["wo"].zero_()
    cache.mark_dirty("e0")
    cache.drop("e0")
    back = store.get("e0")
    F = cfg.d_ff // 2
    assert torch.equal(back["layers"]["mlp"]["wo"][:, F:],
                       host["layers"]["mlp"]["wo"][:, F:])
    assert not back["layers"]["mlp"]["wo"][:, :F].any()
    assert tree_map(lambda t: t.shape, back) == tree_map(lambda t: t.shape,
                                                         host)
