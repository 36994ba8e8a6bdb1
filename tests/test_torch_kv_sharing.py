"""The sharing half of the port's KV pool against the JAX package's: the same
operations on both packages' ``PagedKVCache``, ``PrefixIndex`` and
``SessionManager`` (1 layer, 1 KV head, head_dim 2, f32, block 4: the shapes
do not matter to the books), and after each one the same books: tables,
lengths, refcounts, free list, the ``kv.*`` stats (``allocs``, ``frees``,
``blocks_in_use``, ``peak_blocks``, ``shared_blocks``, ``cow_splits``), the
index's entries and the sessions, the transfer ledger's edges and the
``reclaim`` / ``evict`` flight-recorder events, and the K/V bytes exactly
(a split copies rows, a write scatters them: nothing is summed).

The random-operation case is a plain seeded loop, not a Hypothesis test:
the JAX package's property versions of these checks fail on Hypothesis
deadlines and on load, and this file must not inherit either."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import flightrec as jax_flightrec
from repro.obs.ledger import TransferLedger as JaxLedger
from repro.serving import PagedKVCache as JaxPool
from repro.serving import PrefixIndex as JaxIndex
from repro.serving import SessionManager as JaxSessions
from repro_torch.obs import flightrec
from repro_torch.obs.ledger import TransferLedger
from repro_torch.serving import PagedKVCache, PrefixIndex, SessionManager

B = 4                       # block size
STATS = ("allocs", "frees", "blocks_in_use", "peak_blocks", "shared_blocks",
         "cow_splits")


@pytest.fixture(autouse=True)
def _recorders():
    """A fresh flight recorder in each package for each case."""
    old = (jax_flightrec.set_recorder(jax_flightrec.FlightRecorder()),
           flightrec.set_recorder(flightrec.FlightRecorder()))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    jax_flightrec.set_recorder(old[0])
    flightrec.set_recorder(old[1])


class Twin:
    """The JAX and the port objects side by side; ``both(fn)`` runs ``fn``
    on each and requires the same result or the same exception type."""

    def __init__(self, n_blocks=16, scratch=False, sessions=None,
                 index=False, reclaimers=()):
        self.j = JaxPool(n_blocks, B, n_layers=1, kv_heads=1, head_dim=2,
                         dtype=jnp.float32, scratch=scratch)
        self.t = PagedKVCache(n_blocks, B, n_layers=1, kv_heads=1,
                              head_dim=2, dtype=torch.float32,
                              scratch=scratch, device="cpu")
        self.jl, self.tl = JaxLedger(), TransferLedger()
        self.jidx = self.tidx = self.jsm = self.tsm = None
        if index:
            self.jidx, self.tidx = JaxIndex(self.j), PrefixIndex(self.t)
        if sessions is not None:
            cap = sessions * self.t._per_block_bytes()
            self.jsm = JaxSessions(self.j, ledger=self.jl, max_bytes=cap)
            self.tsm = SessionManager(self.t, ledger=self.tl, max_bytes=cap)
        for name in reclaimers:
            self.j.add_reclaimer({"sm": self.jsm, "idx": self.jidx}[name])
            self.t.add_reclaimer({"sm": self.tsm, "idx": self.tidx}[name])

    def both(self, fj, ft):
        outs = []
        for f in (fj, ft):
            try:
                outs.append(("ok", f()))
            except (ValueError, KeyError, MemoryError) as e:
                outs.append(("raise", type(e)))
        assert outs[0][0] == outs[1][0], outs
        if outs[0][0] == "raise":
            assert outs[0][1] is outs[1][1], outs
        self.check()
        return outs[0][1], outs[1][1]

    # -- the operations ----------------------------------------------------
    def seat(self, rid, tokens):
        """Open ``rid`` and commit positions whose K rows are the token ids
        (V rows their negatives)."""
        t = np.asarray(tokens, np.float32)
        k = t.reshape(1, -1, 1, 1) * np.ones((1, len(t), 1, 2), np.float32)

        def fj():
            self.j.open(rid)
            self.j.append(rid, jnp.asarray(k), jnp.asarray(-k))

        def ft():
            self.t.open(rid)
            self.t.append(rid, torch.as_tensor(k), torch.as_tensor(-k))
        return self.both(fj, ft)

    def append(self, rid, value):
        k = np.full((1, 1, 1, 2), value, np.float32)
        return self.both(
            lambda: self.j.append(rid, jnp.asarray(k), jnp.asarray(-k)),
            lambda: self.t.append(rid, torch.as_tensor(k),
                                  torch.as_tensor(-k)))

    def call(self, name, *args, **kw):
        """The same method on both pools."""
        return self.both(lambda: getattr(self.j, name)(*args, **kw),
                         lambda: getattr(self.t, name)(*args, **kw))

    def on(self, which, name, *args, **kw):
        """The same method on both indexes (``idx``) or managers (``sm``)."""
        j, t = {"idx": (self.jidx, self.tidx),
                "sm": (self.jsm, self.tsm)}[which]
        res = self.both(lambda: getattr(j, name)(*args, **kw),
                        lambda: getattr(t, name)(*args, **kw))
        assert _plain(res[0]) == _plain(res[1]), res
        return res[1]

    def rows(self, rid):
        k, _ = self.t.gather(rid)
        return [int(x) for x in k.numpy()[0, :, 0, 0]]

    # -- the books ---------------------------------------------------------
    def check(self):
        j, t = self.j, self.t
        assert t._tables == j._tables
        assert t._lengths == j._lengths
        assert t._refs == j._refs
        assert t._free == j._free
        assert t.table_version == j.table_version
        assert t.length_version == j.length_version
        for f in STATS:
            assert getattr(t.stats, f) == getattr(j.stats, f), f
        assert np.array_equal(t.k.numpy(), np.asarray(j.k))
        assert np.array_equal(t.v.numpy(), np.asarray(j.v))
        assert t.check_invariants() == j.check_invariants()
        assert t.reclaimable_blocks() == j.reclaimable_blocks()
        if self.tidx is not None:
            assert _entries(self.tidx) == _entries(self.jidx)
            assert (self.tidx.hits, self.tidx.misses) == \
                (self.jidx.hits, self.jidx.misses)
        if self.tsm is not None:
            assert _sessions(self.tsm) == _sessions(self.jsm)
            assert self.tsm.evictions == self.jsm.evictions
            assert self.tsm.bytes_retained() == self.jsm.bytes_retained()
        for edge in ("writeback", "elided"):
            assert self.tl.bytes_moved(edge) == self.jl.bytes_moved(edge)
        assert _events(flightrec) == _events(jax_flightrec)


def _plain(x):
    """Results as plain Python, blocks as ints."""
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    if isinstance(x, list):
        return [int(v) for v in x]
    return x


def _entries(idx):
    return {k: (e.parent, e.block, e.tokens.tolist(), e.last_use,
                e.n_children) for k, e in idx._entries.items()}


def _sessions(sm):
    return {sid: (s.rid, s.expert, s.tokens.tolist(), s.last_use)
            for sid, s in sm._sessions.items()}


def _events(mod):
    return [{k: v for k, v in ev.items() if k != "ts"}
            for ev in mod.get_recorder().events()
            if ev["kind"] in ("reclaim", "evict")]


# ------------------------------------------------------------------ cases
def test_adopt_validation_and_refcounts():
    tw = Twin()
    tw.seat(0, range(10, 10 + 2 * B))                    # two full blocks
    tbl = tw.t.table(0)
    tw.call("pin", tbl)
    tw.call("open", 1, adopt=tbl, adopt_len=2 * B)
    tw.call("unpin", tbl)
    assert [tw.t.refcount(b) for b in tbl] == [2, 2]
    assert tw.t.stats.shared_blocks == 2
    assert tw.rows(1) == tw.rows(0)                      # no copy
    tw.seat(2, range(B))
    one = tw.t.table(2)
    for adopt, n in ((one, 0), (one, B + 1), ([7], 2), (one + tbl, B),
                     ([], 3)):
        tw.call("open", 9, adopt=adopt, adopt_len=n)     # each refused
        assert 9 not in tw.t.open_rids()
    tw.call("open", 1)                                   # already open
    tw.call("free", 0)                                   # owner leaves first
    assert tw.t.stats.shared_blocks == 0
    assert tw.rows(1) == list(range(10, 10 + 2 * B))
    for r in (1, 2):
        tw.call("free", r)
    assert tw.t.stats.blocks_in_use == 0 and tw.t.stats.allocs == 3


def test_cow_split_on_append_and_reserve():
    """A write into an adopted, partly filled shared tail splits it (append
    and reserve alike); an unshared or block-aligned tail is written in
    place. The sharer's bytes never change."""
    tw = Twin(scratch=True)
    tw.seat(0, range(20, 20 + B + 2))                    # full + partial
    tbl = tw.t.table(0)
    for rid, how in ((1, "append"), (2, "reserve")):
        tw.call("pin", tbl)
        tw.call("open", rid, adopt=tbl, adopt_len=B + 2)
        tw.call("unpin", tbl)
        if how == "append":
            tw.append(rid, 99.0)
        else:
            tw.call("reserve", rid, 3)
            tw.call("advance", rid, 1)
        assert tw.t.table(rid)[1] != tbl[1]
        assert tw.rows(0) == list(range(20, 20 + B + 2))
    assert tw.t.stats.cow_splits == 2
    assert tw.rows(1) == list(range(20, 20 + B + 2)) + [99]
    tw.append(0, 5.0)                                    # unshared: in place
    tw.seat(3, range(30, 30 + B))                        # aligned tail
    aligned = tw.t.table(3)
    tw.call("pin", aligned)
    tw.call("open", 4, adopt=aligned, adopt_len=B)
    tw.call("unpin", aligned)
    tw.append(4, 7.0)
    assert tw.t.stats.cow_splits == 2
    for r in range(5):
        tw.call("free", r)
    assert tw.t.stats.blocks_in_use == 0


def test_prefix_index_insert_match_partial_tail_and_reclaim():
    tw = Twin(n_blocks=6, index=True, reclaimers=("idx",))
    toks = np.arange(3 * B + 2, dtype=np.int32)
    tw.seat(0, toks)
    assert tw.on("idx", "insert", "e0", toks, tw.t.table(0)) == 3
    assert tw.on("idx", "insert", "e0", toks, tw.t.table(0)) == 0
    tw.call("free", 0)
    blocks, n = tw.on("idx", "match", "e0", toks)        # all full blocks
    assert n == 3 * B
    tw.call("unpin", blocks)
    blocks, n = tw.on("idx", "match", "e0", toks[:2 * B])
    assert n == 2 * B - 1                                # >= 1 suffix token
    tw.call("unpin", blocks)
    probe = np.concatenate([toks[:B + 2], np.asarray([77, 78], np.int32)])
    blocks, n = tw.on("idx", "match", "e0", probe)       # partial tail
    assert n == B + 2 and len(blocks) == 2
    tw.call("open", 1, adopt=blocks, adopt_len=n)
    tw.call("unpin", blocks)
    tw.append(1, 77.0)                                   # splits the tail
    assert tw.on("idx", "match", "e1", toks) is None     # per expert
    assert tw.on("idx", "match", "e0", toks + 1000) is None
    tw.call("free", 1)
    tw.seat(2, np.arange(50, 50 + 2 * B))
    tw.on("idx", "insert", "e1", np.arange(50, 50 + 2 * B), tw.t.table(2))
    tw.call("free", 2)
    assert tw.t.free_blocks == 1
    tw.call("open", 3)
    tw.call("reserve", 3, 3 * B)                         # LRU leaves go
    assert len(tw.tidx) < 5 and len(tw.t.table(3)) == 3
    assert {e["kind"] for e in _events(flightrec)} == {"reclaim"}
    tw.call("free", 3)
    tw.on("idx", "clear")
    assert tw.t.stats.blocks_in_use == 0


def test_sessions_retain_adopt_evict_and_cap():
    tw = Twin(n_blocks=12, sessions=4, index=True,
              reclaimers=("sm", "idx"))
    toks = np.arange(2 * B + 1, dtype=np.int32)
    tw.seat(0, toks)
    tw.on("sm", "retain", "chat", 0, "e0", toks)
    nxt = np.concatenate([toks, np.asarray([5, 6], np.int32)])
    blocks, n = tw.on("sm", "adopt", "chat", "e0", nxt)  # whole history
    assert n == len(toks) and "chat" not in tw.tsm
    tw.call("open", 1, adopt=blocks, adopt_len=n)
    tw.call("unpin", blocks)
    assert tw.rows(1) == list(range(2 * B + 1))
    tw.on("idx", "insert", "e0", toks, tw.t.table(1))
    tw.on("sm", "retain", "chat", 1, "e0", toks)
    assert tw.on("sm", "adopt", "chat", "e1", nxt) is None   # rerouted
    tw.seat(2, toks)
    tw.on("sm", "retain", "other", 2, "e0", toks)
    assert tw.on("sm", "adopt", "other", "e0",
                 np.asarray([99, 98], np.int32)) is None     # mismatch
    for i in range(3):                                   # over the cap
        seq = np.arange(i * 30, i * 30 + 2 * B, dtype=np.int32)
        tw.seat(10 + i, seq)
        tw.on("sm", "retain", f"s{i}", 10 + i, "e0", seq)
    assert tw.tsm.bytes_retained() <= tw.tsm.max_bytes
    tw.call("open", 20)
    tw.call("reserve", 20, 9 * B)                        # sessions, then idx
    tw.call("free", 20)
    tw.on("sm", "evict_all")
    tw.on("idx", "clear")
    assert tw.t.stats.blocks_in_use == 0
    causes = {e["cause"] for e in _events(flightrec) if e["kind"] == "evict"}
    assert {"session_reroute", "session_mismatch"} <= causes
    assert tw.tl.bytes_moved("writeback") > 0


def test_seeded_random_operations_keep_identical_books():
    """Open, free, index, match, adopt, abandon, append, retain and adopt a
    session, in a seeded random order (a plain loop), on a small pool whose
    exhaustion drives the reclaimers; the books agree after every step and
    the refcounts always cover every reference."""
    for seed in range(4):
        rs = np.random.RandomState(seed)
        tw = Twin(n_blocks=12, sessions=6, index=True,
                  reclaimers=("sm", "idx"))
        rid, live, pins, indexed, n_sessions = 0, [], [], [], 0
        for _ in range(60):
            op = int(rs.randint(9))
            if op == 0:
                n = int(rs.randint(1, 2 * B + 1))
                tw.seat(rid, rs.randint(0, 99, n))   # may exhaust the pool
                if rid in tw.t.open_rids():
                    live.append(rid)
                rid += 1
            elif op == 1 and live:
                tw.call("free", live.pop(0))
            elif op == 2 and live:
                r = live[int(rs.randint(len(live)))]
                indexed.append(tw.rows(r))
                tw.on("idx", "insert", "e0", np.asarray(indexed[-1], np.int32),
                      tw.t.table(r))
            elif op == 3 and indexed:
                seq = indexed[int(rs.randint(len(indexed)))]
                cut = int(rs.randint(1, len(seq) + 2))
                m = tw.on("idx", "match", "e0",
                          np.asarray(seq[:cut] + [1], np.int32))
                if m is not None:
                    pins.append(m)
            elif op == 4 and pins:
                blocks, n = pins.pop()
                tw.call("open", rid, adopt=blocks, adopt_len=n)
                tw.call("unpin", blocks)
                live.append(rid)
                rid += 1
            elif op == 5 and pins:
                tw.call("unpin", pins.pop()[0])
            elif op == 6 and live:
                tw.append(live[int(rs.randint(len(live)))],
                          float(rs.randint(100, 200)))
            elif op == 7 and live:
                r = live.pop(int(rs.randint(len(live))))
                tw.on("sm", "retain", f"s{n_sessions % 3}", r, "e0",
                      np.asarray(tw.rows(r), np.int32))
                n_sessions += 1
            elif op == 8 and n_sessions:
                sid = f"s{int(rs.randint(3))}"
                if sid in tw.tsm:
                    toks = _sessions(tw.tsm)[sid][2] + [7]
                    m = tw.on("sm", "adopt", sid, "e0",
                              np.asarray(toks, np.int32))
                    if m is not None:
                        pins.append(m)
            refs = (tw.t.live_table_refs() + len(tw.tidx)
                    + sum(len(b) for b, _ in pins))
            assert sum(tw.t._refs.values()) == refs
            assert not set(tw.t._refs) & set(tw.t._free)
        for blocks, _ in pins:
            tw.call("unpin", blocks)
        for r in live:
            tw.call("free", r)
        tw.on("sm", "evict_all")
        tw.on("idx", "clear")
        assert tw.t.stats.blocks_in_use == 0, seed
