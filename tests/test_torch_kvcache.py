"""The port's PagedKVCache against the JAX package's on the same sequence of
operations: identical block tables, lengths, free lists and stats, the same
gathered K/V bytes (exact: both only copy data), and clean invariants."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.kvcache import PagedKVCache as JaxPagedKVCache
from repro_torch.serving.kvcache import PagedKVCache

L, H, DH, BLOCK = 2, 2, 8, 4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_sizing_matches_jax():
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32,
                                                     jnp.float32)):
        assert PagedKVCache.block_bytes(16, 32, 32, 128, dt) == \
            JaxPagedKVCache.block_bytes(16, 32, 32, 128, jdt)
    budget = 10 * PagedKVCache.block_bytes(BLOCK, L, H, DH, torch.float32) + 7
    p = PagedKVCache.for_budget(budget, BLOCK, L, H, DH, torch.float32,
                                scratch=True, device="cpu")
    j = JaxPagedKVCache.for_budget(budget, BLOCK, L, H, DH, jnp.float32,
                                   scratch=True)
    assert (p.n_blocks, p.scratch_index, tuple(p.k.shape)) == \
        (j.n_blocks, j.scratch_index, j.k.shape)
    assert p.capacity_bytes() == j.capacity_bytes()
    with pytest.raises(MemoryError):
        PagedKVCache.for_budget(1, BLOCK, L, H, DH, scratch=True,
                                device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_ops_match_jax_pool(seed):
    rs = np.random.RandomState(seed)
    p = PagedKVCache(12, BLOCK, L, H, DH, torch.float32, scratch=True,
                     device="cpu")
    j = JaxPagedKVCache(12, BLOCK, L, H, DH, jnp.float32, scratch=True)
    open_rids, next_rid = [], 0
    for _ in range(60):
        op = rs.randint(4)
        if op == 0 or not open_rids:                  # open + prefill append
            n = int(rs.randint(1, 7))
            if -(-n // BLOCK) > p.free_blocks:
                continue
            k = rs.standard_normal((L, n, H, DH)).astype(np.float32)
            v = rs.standard_normal((L, n, H, DH)).astype(np.float32)
            for pool, conv in ((p, torch.as_tensor), (j, jnp.asarray)):
                pool.open(next_rid)
                pool.append(next_rid, conv(k), conv(v))
            open_rids.append(next_rid)
            next_rid += 1
        elif op == 1:                                 # reserve + advance
            rid = open_rids[rs.randint(len(open_rids))]
            n = int(rs.randint(1, 4))
            need = -(-(p.length(rid) + n) // BLOCK) - len(p.table(rid))
            if need > p.free_blocks:
                continue
            for pool in (p, j):
                pool.reserve(rid, n)
                pool.advance(rid, n)
        elif op == 2:                                 # free
            rid = open_rids.pop(rs.randint(len(open_rids)))
            p.free(rid)
            j.free(rid)
        else:                                         # audit
            for rid in open_rids:
                assert p.table(rid) == j.table(rid)
                np.testing.assert_array_equal(p.padded_table(rid, 6),
                                              j.padded_table(rid, 6))
        assert p.free_blocks == j.free_blocks
        assert p.stats.blocks_in_use == j.stats.blocks_in_use
        assert p.check_invariants() == [] == j.check_invariants()
    for rid in open_rids:
        assert p.length(rid) == j.length(rid)
        pk, pv = p.gather(rid)
        jk, jv = j.gather(rid)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    for rid in list(open_rids):
        p.free(rid)
    assert p.stats.blocks_in_use == 0 and p.free_blocks == p.n_blocks
    assert (p.stats.allocs, p.stats.frees) == (p.stats.frees, p.stats.allocs)


def test_versions_and_errors():
    p = PagedKVCache(3, BLOCK, L, H, DH, torch.float32, scratch=True,
                     device="cpu")
    tv, lv = p.table_version, p.length_version
    p.open(0)
    p.reserve(0, 5)
    assert p.table_version > tv and p.length_version > lv
    assert p.padded_table(0, 3).tolist() == p.table(0) + [p.scratch_index]
    with pytest.raises(KeyError):
        p.open(0)
    with pytest.raises(RuntimeError):
        p.advance(0, 9)
    p.reserve(0, 12)
    with pytest.raises(MemoryError):
        p.reserve(0, 13)
    p.free(0)
    assert p.check_invariants() == []


def test_default_device_is_the_card(monkeypatch):
    """Without ``device`` the pool is on the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(3, BLOCK, L, H, DH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache.for_budget(
            4 * PagedKVCache.block_bytes(BLOCK, L, H, DH), BLOCK, L, H, DH)
    assert PagedKVCache(3, BLOCK, L, H, DH, device="cpu").k.device.type == \
        "cpu"
