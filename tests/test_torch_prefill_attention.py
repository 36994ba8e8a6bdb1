"""The port's prefill attention against the JAX package on the CPU, on the
same numpy inputs: ``kernels.flash_attention.ops.attention`` (the
``flash_prefill`` wrapper, which takes its plain version on the CPU) against
JAX's Pallas kernel in interpret mode and against its ``attention_ref`` at
ragged lengths; ``layers.attention`` against JAX's ``L.attention`` on both
of JAX's branches (its quadratic oracle and its streaming-block form: the
port's plain version is the oracle at every length); and the reduced
expert's forward at a length where JAX takes the block form.

Tolerance: f32 max |err| <= 1e-4 (the frameworks sum in different orders,
and the Pallas kernel scales q before the product where the port scales
the scores after it); bf16 within ``tests/test_kernels.py::_tol`` (2e-2:
the two round the probabilities to bf16 at different points)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.flash_attention import attention as jax_flash
from repro.kernels.flash_attention import ref as jax_ref
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import array_to_tensor, to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = {np.float32: 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, B, S, hq, hkv, dh, dtype):
    rs = np.random.RandomState(seed)
    arrs = [rs.standard_normal((B, S, h, dh)).astype(np.float32)
            for h in (hq, hkv, hkv)]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrs]
    return arrs


def _check(got: torch.Tensor, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


# (G, dh, window, S) at the lengths the Pallas kernel takes (S % 128 == 0):
# every G in {1, 2, 4}, every dh in {32, 64, 128, 256}, both windows, both S
_ALIGNED = [(1, 32, 0, 128), (2, 64, 48, 256), (4, 128, 0, 256),
            (4, 256, 48, 128), (1, 256, 0, 256), (2, 32, 48, 128)]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_ops_attention_matches_the_pallas_kernel(dtype):
    for i, (G, dh, window, S) in enumerate(_ALIGNED):
        hkv = 2 if dh <= 64 else 1
        q, k, v = _qkv(i, 1, S, G * hkv, hkv, dh, dtype)
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, window=window, interpret=True)
        got = attention(array_to_tensor(q), array_to_tensor(k),
                        array_to_tensor(v), causal=True, window=window)
        assert got.dtype == (torch.float32 if dtype is np.float32
                             else torch.bfloat16)
        _check(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_ops_attention_at_ragged_lengths_matches_the_oracle(dtype):
    """S in {1, 17, 200}: lengths the port's prefill meets and the Pallas
    kernel refuses; JAX reaches the same function through its oracle."""
    for S in (1, 17, 200):
        for window in (0, 48):
            q, k, v = _qkv(S + window, 2, S, 4, 2, 32, dtype)
            want = jax_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True,
                                         window=window)
            got = attention(array_to_tensor(q), array_to_tensor(k),
                            array_to_tensor(v), causal=True, window=window)
            _check(got, want, TOL[dtype])


@pytest.mark.parametrize("S", [96, 256])
def test_layers_attention_on_both_cpu_branches(S):
    """JAX's attn_chunk = 64: there S = 96 takes the quadratic oracle,
    S = 256 the streaming-block form; the port's plain version (the oracle
    at every length) agrees with both."""
    jcfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    assert 96 <= 2 * jcfg.attn_chunk < 256
    for window in (0, 48):
        q, k, v = _qkv(S + window, 2, S, 4, 2, 32, np.float32)
        want = JL.attention(jcfg, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v), window=window)
        got = L.attention(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), window=window)
        _check(got, want, TOL[np.float32])


def test_expert_forward_on_the_block_branch_matches_jax():
    """The reduced expert at S = 256 (> 2 attn_chunk): every layer's
    attention takes JAX's streaming-block branch, the port's oracle."""
    jcfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    cfg = reduced(get_config("samba-coe-expert-7b"))
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jax_get_model(jcfg).init(jax.random.PRNGKey(3)))
    tokens = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, 256)).astype(np.int32)
    want = JT.forward(jcfg, params, {"tokens": jnp.asarray(tokens)})
    got = T.forward(cfg, to_torch(params),
                    {"tokens": torch.as_tensor(tokens, dtype=torch.long)})
    _check(got, want, TOL[np.float32])
