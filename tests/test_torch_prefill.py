"""The port's packed prefill against the JAX package's: the bucket and
packing plans are identical, the packed forward's logits and K/V agree at f32
within atol 1e-4, and the scatter lands the same K/V in the same pool rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import get_model as jax_get_model
from repro.serving import prefill as JP
from repro.serving.kvcache import PagedKVCache as JaxPagedKVCache
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.serving import prefill as P
from repro_torch.serving.kvcache import PagedKVCache

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    cfg = reduced(get_config("samba-coe-expert-7b"))
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jax_get_model(jcfg).init(jax.random.PRNGKey(3)))
    return jcfg, cfg, params


def test_bucket_and_pack_plans_match_jax():
    rs = np.random.RandomState(0)
    for max_len in (1, 16, 17, 100, 512, 4096):
        assert P.default_buckets(max_len) == JP.default_buckets(max_len)
    buckets = P.default_buckets(128)
    for n in (1, 16, 17, 64, 128):
        assert P.bucket_for(n, buckets) == JP.bucket_for(n, buckets)
    for _ in range(20):
        lens = list(rs.randint(1, 100, size=rs.randint(1, 12)))
        seg = int(rs.randint(1, 6))
        assert P.plan_packs(lens, buckets, seg) == \
            JP.plan_packs(lens, buckets, seg)
    with pytest.raises(ValueError):
        P.bucket_for(129, buckets)


def test_packed_attention_matches_jax():
    rs = np.random.RandomState(1)
    q = rs.standard_normal((1, 12, 4, 16)).astype(np.float32)
    k = rs.standard_normal((1, 12, 2, 16)).astype(np.float32)
    v = rs.standard_normal((1, 12, 2, 16)).astype(np.float32)
    seg = np.asarray([[0] * 5 + [1] * 4 + [2] * 3], np.int32)
    got = P.packed_attention(*map(torch.as_tensor, (q, k, v, seg)))
    want = JP.packed_attention(*map(jnp.asarray, (q, k, v, seg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_packed_runner_and_scatter_match_jax(setup):
    jcfg, cfg, params = setup
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 11, 3)]
    buckets, block = (8, 16, 32), 4
    jr = JP.PackedPrefillRunner(jcfg, buckets=buckets, max_segments=4)
    pr = P.PackedPrefillRunner(cfg, buckets=buckets, max_segments=4)
    jres = jr(params, prompts)
    res = pr(to_torch(params), prompts)
    assert (res.bucket, res.spans) == (jres.bucket, jres.spans)
    np.testing.assert_allclose(res.logits[:3].numpy(),
                               np.asarray(jres.logits[:3]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(res.k.numpy(), np.asarray(jres.k), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(res.v.numpy(), np.asarray(jres.v), atol=ATOL,
                               rtol=0)

    shape = (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    jpool = JaxPagedKVCache(16, block, *shape, dtype=jnp.float32,
                            scratch=True)
    pool = PagedKVCache(16, block, *shape, dtype=torch.float32, scratch=True,
                        device="cpu")
    jr.scatter_into(jpool, jres, [10, 11, 12], extra_tokens=[2, 0, 5])
    pr.scatter_into(pool, res, [10, 11, 12], extra_tokens=[2, 0, 5])
    for rid in (10, 11, 12):
        assert pool.table(rid) == jpool.table(rid)
        assert pool.length(rid) == jpool.length(rid)
        k, v = pool.gather(rid)
        jk, jv = jpool.gather(rid)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL,
                                   rtol=0)
    assert pool.check_invariants() == []
