"""The port's HBMWeightCache against the JAX package's on the failure paths of
a prefetch: a store read that raises on the prefetch is retried inline as a
miss, and a prefetch of an expert the store does not hold is skipped. Both
packages must reach the same outcome."""
import time

import numpy as np
import pytest
import torch

from repro.core.switching import HBMWeightCache as JaxCache
from repro.store import HostMemoryStore as JaxStore
from repro_torch.core.switching import HBMWeightCache
from repro_torch.store import HostMemoryStore


def _store(base, fail_first):
    class FailOnce(base):
        """A store whose first ``get`` raises, as a transient read fault."""

        def __init__(self):
            super().__init__()
            self.fail_next = fail_first

        def get(self, name):
            if self.fail_next:
                self.fail_next = False
                raise IOError("transient capacity-tier read failure")
            return super().get(name)
    return FailOnce()


def _caches(w, fail_first):
    js, ts = _store(JaxStore, fail_first), _store(HostMemoryStore, fail_first)
    js.put("e0", {"w": w})
    ts.put("e0", {"w": torch.from_numpy(w)})
    return JaxCache(1 << 20, store=js), HBMWeightCache(1 << 20, ts, "cpu")


def _wait_landed(cache, expert_id):
    deadline = time.time() + 5.0
    while not cache._inflight[expert_id].done():
        assert time.time() < deadline
        time.sleep(0.005)


def test_failed_prefetch_reloads_as_miss_like_jax():
    w = np.random.RandomState(0).standard_normal(256).astype(np.float32)
    jc, tc = _caches(w, fail_first=True)
    outcome = {}
    for name, cache in (("jax", jc), ("torch", tc)):
        assert cache.prefetch("e0") is True
        _wait_landed(cache, "e0")
        assert not cache.ready("e0")            # a dead load is no hit
        value = cache.activate("e0")            # retried inline as a miss
        np.testing.assert_array_equal(np.asarray(value["w"]), w)
        st = cache.stats.as_dict()
        assert st["stall_failed_prefetch_seconds"] >= 0.0
        outcome[name] = {k: st[k] for k in ("prefetch_failures", "misses",
                                            "hits", "prefetch_hits")}
        assert cache.resident("e0") and not cache._reserved
        cache.close()
    assert outcome["torch"] == outcome["jax"] == {
        "prefetch_failures": 1, "misses": 1, "hits": 0, "prefetch_hits": 0}


def test_prefetch_of_unknown_expert_is_skipped_like_jax():
    jc, tc = _caches(np.zeros(16, np.float32), fail_first=False)
    for cache in (jc, tc):
        assert cache.prefetch("missing") is False
        assert not cache._inflight and not cache._reserved
        assert cache.stats.prefetches_issued == 0
        cache.close()
    with pytest.raises(KeyError):
        tc.activate("missing")                  # a demand miss still raises
