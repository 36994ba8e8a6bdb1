"""The multi-token paged extend (g > 1) of the port against the JAX
package's ``xla_paged_extend``, on the same f32 weights (JAX init through
``bridge``), pools, tables and tokens, at g in {1, 2, 5}: inactive lanes, a
lane whose real suffix is shorter than g (its padded positions run past its
reserved blocks into the table's scratch padding) and lanes straddling
blocks. Logits of the active lanes agree within 1e-4 of the largest logit;
the pools agree within 1e-5 at every row but the scratch row (which several
lanes write at once: which duplicate wins is not defined), and no position
committed before the step changes.

``FusedPagedBackend`` routes g > 1 to the plain body by shape (JAX's
``extend_fn`` does the same: no Pallas kernel computes a g > 1 step): on
the CPU its result equals the plain body's exactly, and it never reaches a
paged kernel's wrapper."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import get_model as jax_get_model
from repro.serving import backends as JB
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.serving import backends as B

LOGIT_TOL_REL = 1e-4     # of the largest logit, f32
POOL_ATOL = 1e-5
BLOCK, MAXB = 4, 4       # 16 positions a table


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(
        jax_reduced(jax_get_config("samba-coe-expert-7b")), n_layers=2)
    cfg = dataclasses.replace(reduced(get_config("samba-coe-expert-7b")),
                              n_layers=2)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jax_get_model(jcfg).init(jax.random.PRNGKey(3)))
    return jcfg, cfg, params


def _state(cfg, g, seed):
    """Pools full of random rows; lanes: 0 active at 3 (straddles a block at
    g 2 and 5), 1 inactive, 2 active at 6 with a short suffix (2 real
    tokens; its reserved blocks cover 6 + 2, so at g 5 the padded
    positions run into the scratch padding), 3 active at 0 (an empty
    lane)."""
    rs = np.random.RandomState(seed)
    n_blocks = 12
    scratch = n_blocks
    shape = (cfg.n_layers, n_blocks + 1, BLOCK, cfg.n_kv_heads, cfg.head_dim)
    pk = rs.standard_normal(shape).astype(np.float32)
    pv = rs.standard_normal(shape).astype(np.float32)
    lengths = np.asarray([3, 5, 6, 0], np.int32)
    reserved = [-(-(3 + g) // BLOCK), 2, -(-(6 + 2) // BLOCK),
                -(-g // BLOCK)]
    perm = rs.permutation(n_blocks)
    tables = np.full((4, MAXB), scratch, np.int32)
    at = 0
    for i, n in enumerate(reserved):
        tables[i, :n] = perm[at:at + n]
        at += n
    active = np.asarray([True, False, True, True])
    tokens = rs.randint(0, cfg.vocab_size, (4, g)).astype(np.int32)
    return pk, pv, tables, lengths, active, tokens, scratch


def _port(fn, cfg, params, pk, pv, tables, lengths, active, tokens, scratch):
    logits, k, v = fn(cfg, to_torch(params), torch.tensor(pk),
                      torch.tensor(pv), torch.as_tensor(tables),
                      torch.as_tensor(lengths), torch.as_tensor(active),
                      torch.as_tensor(tokens).long(), scratch)
    return logits.numpy(), k.numpy(), v.numpy()


def _committed_rows(pool, tables, lengths):
    """{(lane, position): the pool's (L, Hkv, dh) values} below each lane's
    length."""
    return {(b, p): pool[:, tables[b, p // BLOCK], p % BLOCK]
            for b in range(len(lengths)) for p in range(int(lengths[b]))}


def test_paged_extend_matches_jax_at_several_widths(model):
    jcfg, cfg, params = model
    for g in (1, 2, 5):
        pk, pv, tables, lengths, active, tokens, scratch = \
            _state(cfg, g, seed=10 + g)
        jl, jk, jv = JB.xla_paged_extend(
            jcfg, params, jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(active),
            jnp.asarray(tokens), scratch)
        jl, jk, jv = (np.asarray(x) for x in (jl, jk, jv))
        got, k, v = _port(B.xla_paged_extend, cfg, params, pk, pv, tables,
                          lengths, active, tokens, scratch)
        assert got.shape == (4, g, cfg.vocab_size)
        tol = LOGIT_TOL_REL * float(np.abs(jl[active]).max())
        np.testing.assert_allclose(got[active], jl[active], atol=tol, rtol=0,
                                   err_msg=f"g={g}")
        # every row but scratch: the committed positions and the new ones
        np.testing.assert_allclose(k[:, :scratch], jk[:, :scratch],
                                   atol=POOL_ATOL, rtol=0, err_msg=f"g={g}")
        np.testing.assert_allclose(v[:, :scratch], jv[:, :scratch],
                                   atol=POOL_ATOL, rtol=0, err_msg=f"g={g}")
        # nothing committed before the step moved, in either package
        for pool, before in ((k, pk), (v, pv), (jk, pk), (jv, pv)):
            for key, want in _committed_rows(before, tables, lengths).items():
                np.testing.assert_array_equal(
                    _committed_rows(pool, tables, lengths)[key], want,
                    err_msg=f"g={g} lane/position {key}")
        # the short suffix's real positions landed where decode reads them
        for j in range(min(g, 2)):
            p = 6 + j
            np.testing.assert_allclose(
                k[:, tables[2, p // BLOCK], p % BLOCK],
                jk[:, tables[2, p // BLOCK], p % BLOCK], atol=POOL_ATOL,
                rtol=0)


def test_positions_past_a_full_table_go_to_scratch(model):
    """A lane whose table has no scratch padding: padded positions past the
    table are written to the scratch row, so no committed position of any
    lane (its own last block included) changes."""
    _, cfg, params = model
    g = 5
    pk, pv, tables, lengths, active, tokens, scratch = _state(cfg, g, 21)
    used = set(tables[tables != scratch].tolist())
    free = [b for b in range(scratch) if b not in used]
    tables[1] = free[:MAXB]                      # lane 1: a full table
    lengths[1] = MAXB * BLOCK - 2                # 2 real positions, 3 past
    active[1] = True
    _, k, v = _port(B.xla_paged_extend, cfg, params, pk, pv, tables,
                    lengths, active, tokens, scratch)
    for pool, before in ((k, pk), (v, pv)):
        for key, want in _committed_rows(before, tables, lengths).items():
            np.testing.assert_array_equal(
                _committed_rows(pool, tables, lengths)[key], want,
                err_msg=f"lane/position {key}")


def test_fused_backend_routes_multi_token_steps_to_the_plain_body(
        model, monkeypatch):
    """g > 1 through ``FusedPagedBackend`` is the plain body, bit for bit,
    and never calls a paged kernel's wrapper (the wrappers are replaced by
    ones that raise)."""
    import repro_torch.kernels.flash_attention.ops as attn_ops
    import repro_torch.kernels.fused_decode.ops as fused_ops
    from repro_torch.kernels import runtime as rt

    _, cfg, params = model
    backend = B.FusedPagedBackend(cfg)

    def refuse(*a, **k):
        raise AssertionError("a paged kernel's wrapper was called at g > 1")

    for g in (2, 5):
        args = _state(cfg, g, seed=30 + g)
        want = _port(B.xla_paged_extend, cfg, params, *args)
        with monkeypatch.context() as m:
            for mod, name in ((attn_ops, "decode_paged"),
                              (fused_ops, "qkv_rope_paged"),
                              (fused_ops, "oproj_ffn_swiglu")):
                m.setattr(mod, name, refuse)
            rt.reset_launches()
            pk, pv, tables, lengths, active, tokens, scratch = args
            got = backend.extend(
                to_torch(params), torch.tensor(pk), torch.tensor(pv),
                torch.as_tensor(tables), torch.as_tensor(lengths),
                torch.as_tensor(active), torch.as_tensor(tokens).long(),
                scratch)
            assert all(n == 0 for n in rt.launch_counts().values())
        for a, b in zip(want, got):
            assert np.array_equal(a, b.numpy()), f"g={g}"
    # g = 1 still takes the kernels' route (their plain versions on the CPU)
    calls = []
    real = fused_ops.qkv_rope_paged
    monkeypatch.setattr(fused_ops, "qkv_rope_paged",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pk, pv, tables, lengths, active, tokens, scratch = _state(cfg, 1, 40)
    backend.extend(to_torch(params), torch.tensor(pk), torch.tensor(pv),
                   torch.as_tensor(tables), torch.as_tensor(lengths),
                   torch.as_tensor(active), torch.as_tensor(tokens).long(),
                   scratch)
    assert len(calls) == cfg.n_layers
