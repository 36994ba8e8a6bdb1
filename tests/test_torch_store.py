"""The expert tier's stores (the port's ``store``) against the JAX package's
on the same trees:

  * ``MmapFileStore``: a directory the JAX store wrote reads in the port and
    the other way round, leaf bytes identical for f32, bf16 and int leaves,
    nested lists and tuples; both write byte-identical files;
  * ``Int8BlockQuantizedStore``: codes, scales and dequantized leaves
    bit-identical to JAX's for f32 and bf16 leaves (absmax / 127 in f32,
    round half to even), non-float leaves passed through, the same
    ``stored_bytes`` and compression ratio;
  * ``make_store`` specs, ``delete`` / ``keys`` / ``len`` / ``in`` and the
    composition's ``memory_contract`` as JAX reports them.
No tolerance: every comparison is exact."""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.store import Int8BlockQuantizedStore as JaxInt8
from repro.store import MmapFileStore as JaxMmap
from repro.store import make_store as jax_make_store
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.store import (HostMemoryStore, Int8BlockQuantizedStore,
                               MmapFileStore, make_store)


def _tree(seed):
    """Params-shaped tree: f32 and bf16 leaves of odd sizes (the int8
    padding), an all-zero leaf (scale 1.0), an int leaf, a scalar, nested
    lists and a tuple."""
    rs = np.random.RandomState(seed)
    f32 = lambda *s: rs.standard_normal(s).astype(np.float32)
    return {"embed": {"tok": f32(37, 16).astype(ml_dtypes.bfloat16)},
            "layers": {"wq": f32(2, 16, 3, 8),
                       "scale": f32(130).astype(ml_dtypes.bfloat16),
                       "zeros": np.zeros((70,), np.float32)},
            "pos": np.arange(11, dtype=np.int32),
            "step": np.float32(3.5),
            "stack": [f32(5), [f32(3, 3).astype(ml_dtypes.bfloat16)]],
            "pair": (f32(9), np.arange(4, dtype=np.int64))}


def _torch_tree(tree):
    """The numpy tree as torch tensors (tuples kept, as the manifest has
    them)."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return to_torch(np.asarray(tree))


def _assert_same(port, jax_tree):
    """Port tree (tensors) == numpy tree, leaf bytes and structure."""
    if isinstance(jax_tree, dict):
        assert isinstance(port, dict) and port.keys() == jax_tree.keys()
        for k in jax_tree:
            _assert_same(port[k], jax_tree[k])
        return
    if isinstance(jax_tree, (list, tuple)):
        assert type(port) is type(jax_tree) and len(port) == len(jax_tree)
        for a, b in zip(port, jax_tree):
            _assert_same(a, b)
        return
    want = np.asarray(jax_tree)
    got = to_numpy(port)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_mmap_directories_are_interchangeable_with_jax(tmp_path):
    trees = {f"e{i}": _tree(i) for i in range(2)}
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    js = JaxMmap(jdir)
    ps = MmapFileStore(pdir)
    for name, t in trees.items():
        js.put(name, t)
        ps.put(name, _torch_tree(t))
    for name, t in trees.items():
        for ext in (".bin", ".json"):        # the same file, byte for byte
            assert ((pdir / (name + ext)).read_bytes()
                    == (jdir / (name + ext)).read_bytes()), (name, ext)
        # each package reads the other's directory
        _assert_same(MmapFileStore(jdir).get(name), t)
        _assert_same(MmapFileStore(jdir, eager=True).get(name), t)
        got = JaxMmap(pdir).get(name)
        _assert_same(_torch_tree(got), t)
        assert ps.nbytes(name) == js.nbytes(name)
        assert ps.stored_bytes(name) == js.stored_bytes(name)


def test_mmap_get_maps_copy_on_write_and_rewrites_replace(tmp_path):
    """A write into a lazy ``get``'s tensor never reaches the file; a
    ``put`` over an expert replaces its file, so a map taken before keeps
    the old bytes; stats count as JAX's do."""
    t = _torch_tree(_tree(3))
    lazy = MmapFileStore(tmp_path)
    lazy.put("e", t)
    a, b = lazy.get("e"), lazy.get("e")
    a["layers"]["wq"].add_(1.0)
    assert torch.equal(b["layers"]["wq"], t["layers"]["wq"])
    assert torch.equal(MmapFileStore(tmp_path).get("e")["layers"]["wq"],
                       t["layers"]["wq"])
    t2 = _torch_tree(_tree(4))
    lazy.put("e", t2)
    assert torch.equal(b["layers"]["wq"], t["layers"]["wq"])
    for eager in (False, True):
        got = MmapFileStore(tmp_path, eager=eager).get("e")
        assert torch.equal(got["layers"]["wq"], t2["layers"]["wq"])
    assert lazy.stats.reads == 2 and lazy.stats.writes == 2
    assert not list(tmp_path.glob("*.tmp"))


def _qleaves(store, name):
    """(codes, scales) arrays of each quantized leaf, dict leaves in key
    order."""
    out = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif hasattr(x, "codes"):
            c, s = x.codes, x.scales
            out.append((np.asarray(c.numpy() if torch.is_tensor(c) else c),
                        np.asarray(s.numpy() if torch.is_tensor(s) else s)))
    walk(store._trees[name])
    return out


def test_int8_codes_scales_and_dequant_bit_identical_to_jax():
    for block in (64, 7, 1):
        for seed in range(3):
            t = _tree(seed)
            t = {k: v for k, v in t.items() if k not in ("stack", "pair")}
            t["big"] = (np.random.RandomState(seed).standard_normal(1000)
                        * 10 ** seed).astype(np.float32)
            js, ps = JaxInt8(block), Int8BlockQuantizedStore(block)
            js.put("e", t)
            ps.put("e", to_torch(t))
            jq, pq = _qleaves(js, "e"), _qleaves(ps, "e")
            assert len(jq) == len(pq) == 6
            for (jc, jsc), (pc, psc) in zip(jq, pq):
                assert jc.dtype == pc.dtype == np.int8
                np.testing.assert_array_equal(pc, jc)
                assert psc.dtype == jsc.dtype == np.float32
                assert psc.tobytes() == jsc.tobytes()
            _assert_same(ps.get("e"), js.get("e"))
            assert ps.nbytes("e") == js.nbytes("e")
            assert ps.stored_bytes("e") == js.stored_bytes("e")
            assert ps.compression_ratio("e") == js.compression_ratio("e")


def test_int8_bf16_capacity_and_error_bound():
    """A bf16 expert at block 64 stores 1 + 4/64 bytes an element against
    2: stored / nbytes = 1.0625 / 2; each element within absmax / 254 of
    its block."""
    rs = np.random.RandomState(5)
    w = torch.as_tensor(rs.standard_normal((64, 640)).astype(np.float32))
    t = {"w": w.to(torch.bfloat16)}
    s = Int8BlockQuantizedStore(64)
    s.put("e", t)
    assert s.stored_bytes("e") / s.nbytes("e") == 1.0625 / 2
    back = s.get("e")["w"].float().reshape(-1, 64)
    ref = t["w"].float().reshape(-1, 64)
    bound = ref.abs().amax(dim=1, keepdim=True) / 254
    # the dequantized value is rounded back to bf16: one more half unit
    assert ((back - ref).abs() <= bound + ref.abs() * 2 ** -8).all()
    with pytest.raises(ValueError):
        Int8BlockQuantizedStore(0)


def test_make_store_specs_and_errors_match_jax(tmp_path):
    for spec, kw, cls in (("host", {}, HostMemoryStore),
                          (f"mmap:{tmp_path / 'a'}", {}, MmapFileStore),
                          ("mmap", {"root": tmp_path / "b"}, MmapFileStore),
                          ("int8", {}, Int8BlockQuantizedStore),
                          ("int8:32", {}, Int8BlockQuantizedStore)):
        s, js = make_store(spec, **kw), jax_make_store(spec, **kw)
        assert isinstance(s, cls) and type(js).__name__ == cls.__name__
        if cls is Int8BlockQuantizedStore:
            assert s.block == js.block
        if cls is MmapFileStore:
            assert s.root == js.root
    for bad in ("mmap", "zip", "int8:x"):
        with pytest.raises(ValueError) as pe:
            make_store(bad)
        with pytest.raises(ValueError) as je:
            jax_make_store(bad)
        assert str(pe.value) == str(je.value)


def test_store_books_delete_keys_len_match_jax(tmp_path):
    t = {k: v for k, v in _tree(1).items() if k not in ("stack", "pair")}
    for kind in ("host", "mmap", "int8"):
        if kind == "mmap":
            s = make_store(f"mmap:{tmp_path / 'port'}")
            js = jax_make_store(f"mmap:{tmp_path / 'jax'}")
        else:
            s, js = make_store(kind), jax_make_store(kind)
        for name in ("a", "b", "c"):
            s.put(name, to_torch(t))
            js.put(name, t)
        s.delete("b")
        js.delete("b")
        assert sorted(s.keys()) == sorted(js.keys()) == ["a", "c"]
        assert len(s) == len(js) == 2
        assert ("b" in s) == ("b" in js) is False and "a" in s
        assert s.total_stored_bytes() == js.total_stored_bytes()
        assert s.cheap_nbytes is js.cheap_nbytes is True
        assert s.stats.as_dict() == {**js.stats.as_dict()}


def test_memory_contract_reports_the_capacity_tier_bytes():
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.core import CompositionOfExperts as JaxCoE
    from repro.core import ExpertHandle as JaxHandle
    from repro.core import HashRouter as JaxHashRouter
    from repro.models import get_model as jax_get_model
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import (CompositionOfExperts, ExpertHandle,
                                  HashRouter)
    jcfg = jax_reduced(jax_get_config("samba-coe-expert-7b"))
    cfg = reduced(get_config("samba-coe-expert-7b"))
    tree = jax.tree.map(np.asarray,
                        jax_get_model(jcfg).init(jax.random.PRNGKey(0)))
    nb = sum(x.nbytes for x in jax.tree.leaves(tree))
    coe = CompositionOfExperts(HashRouter(1), None, 2 * nb, device="cpu",
                               store=Int8BlockQuantizedStore(64))
    jcoe = JaxCoE(JaxHashRouter(1), None, 2 * nb, store=JaxInt8(64))
    coe.register(ExpertHandle("e0", cfg, to_torch(tree)))
    jcoe.register(JaxHandle("e0", jcfg, tree))
    c = coe.memory_contract("e0")
    assert c == jcoe.memory_contract("e0")
    assert c["ddr_bytes"] < c["hbm_bytes"] == nb
