"""Parameter trees between the JAX package and the port (repro_torch.bridge):
the reduced samba-coe-expert-7b tree round-trips bit-exactly, bf16 leaves
included, with the JAX package's keys, shapes and layout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import get_model as jax_get_model
from repro_torch.bridge import to_numpy, to_torch, tree_leaves
from repro_torch.configs import get_config, reduced
from repro_torch.models import get_model


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    params = jax_get_model(cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def test_reduced_tree_round_trips_bit_exactly(jax_tree):
    t = to_torch(jax_tree)
    back = to_numpy(t)
    a, b = _flat(jax_tree), _flat(back)
    assert a.keys() == b.keys()
    n_bf16 = 0
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert a[k].dtype == b[k].dtype, k
        bits = np.uint16 if a[k].dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(a[k].view(bits), b[k].view(bits), k)
        n_bf16 += a[k].dtype == jnp.bfloat16
    assert n_bf16 > 0                     # the bf16 path was exercised


def test_bf16_leaves_become_torch_bf16_with_same_values(jax_tree):
    t = to_torch(jax_tree)
    wq = t["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(), jax_tree["layers"]["attn"]["wq"].astype(np.float32))


def test_port_specs_match_jax_tree_layout(jax_tree):
    cfg = reduced(get_config("samba-coe-expert-7b"))
    gen = torch.Generator().manual_seed(0)
    ours = _flat(get_model(cfg).init(gen, "cpu"))
    theirs = _flat(jax_tree)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape, k
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(
        get_model(cfg).init(gen, "cpu")))


def test_float32_tree_round_trips(jax_tree):
    f32 = jax.tree.map(lambda x: x.astype(np.float32), jax_tree)
    back = to_numpy(to_torch(f32))
    for k, v in _flat(f32).items():
        np.testing.assert_array_equal(v, _flat(back)[k])
