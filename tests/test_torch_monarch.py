"""The port's Monarch-FFT wrappers against the JAX package on the CPU, on the
same numpy inputs: ``kernels.monarch_fft.ops.monarch`` / ``monarch_conv``
(which take their plain versions on the CPU) against JAX's Pallas kernels
in interpret mode and against JAX's ``monarch_ref``; the Table I ledger;
the showcase entry point ``launch.monarch_fftconv``; the shapes both
refuse; and a CUDA tensor never reaching the plain versions.

Tolerances: f32 within rtol 1e-5 (atol 1e-5 for values near 0) of the
Pallas kernel: the two sum in different orders. bf16 within JAX's own test
tolerance of the Pallas kernel (``tests/test_kernels.py::test_monarch``:
atol 0.1, rtol 0.05; the kernel keeps f32 where the oracle rounds), and
within one bf16 unit of max(|value|, 1) of JAX's ``monarch_ref``, which
rounds at the same points: the summation orders differ, so a rare
intermediate rounds the other way. The conv in f32 within JAX's relative
limit of 1e-4 of the largest output (``test_kernels.py:144``)."""
import pathlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.monarch_fft import monarch as jax_monarch
from repro.kernels.monarch_fft import monarch_conv as jax_monarch_conv
from repro.kernels.monarch_fft import operational_intensity as jax_oi
from repro.kernels.monarch_fft import ref as jax_ref
from repro_torch.kernels import runtime as rt
from repro_torch.kernels.monarch_fft import ops
from repro_torch.launch import monarch_fftconv as M

SHAPES = ((2, 128, 256), (1, 256, 128), (3, 128, 128))   # JAX's test shapes


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(B, N1, N2, seed=0, conv=False):
    """numpy f32 inputs as the JAX tests draw them: x, twiddles and filter
    N(0, 1), each factor N(0, 1) / sqrt(its size)."""
    rs = np.random.RandomState(seed)
    n = lambda *s: rs.standard_normal(s).astype(np.float32)
    args = [n(B, N1, N2), n(N1, N1) / np.sqrt(N1), n(N1, N2),
            n(N2, N2) / np.sqrt(N2)]
    if conv:
        args += [n(N2, N1), n(N2, N2) / np.sqrt(N2), n(N2, N1),
                 n(N1, N1) / np.sqrt(N1)]
    return args


def _bf16(args):
    return [a.astype(ml_dtypes.bfloat16) for a in args], \
        [torch.as_tensor(a).to(torch.bfloat16) for a in args]


def test_monarch_f32_matches_pallas():
    for i, shape in enumerate(SHAPES):
        args = _inputs(*shape, seed=i)
        want = np.asarray(jax_monarch(*map(jnp.asarray, args),
                                      interpret=True))
        rt.reset_launches()
        got = ops.monarch(*map(torch.as_tensor, args))
        assert rt.launch_counts()["monarch_fused"] == 0
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_monarch_bf16_matches_pallas_and_oracle():
    for i, shape in enumerate(SHAPES):
        j_args, t_args = _bf16(_inputs(*shape, seed=10 + i))
        got = ops.monarch(*t_args)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        kern = np.asarray(jax_monarch(*map(jnp.asarray, j_args),
                                      interpret=True)).astype(np.float32)
        np.testing.assert_allclose(got, kern, atol=2e-2 * 5, rtol=0.05)
        want = np.asarray(jax_ref.monarch_ref(*map(jnp.asarray, j_args))) \
            .astype(np.float32)
        unit = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)
        assert (np.abs(got - want) <= unit).all(), shape
        assert (got == want).mean() > 0.99, shape     # mostly bit-equal


def test_monarch_conv_f32_matches_pallas():
    args = _inputs(2, 128, 128, seed=3, conv=True)
    want = np.asarray(jax_monarch_conv(*map(jnp.asarray, args),
                                       interpret=True))
    got = ops.monarch_conv(*map(torch.as_tensor, args)).numpy()
    assert got.shape == want.shape == (2, 128, 128)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    # and in bf16 against JAX's oracle, which rounds where the port does
    j_args, t_args = _bf16(args)
    got = ops.monarch_conv(*t_args).float().numpy()
    want = np.asarray(jax_ref.monarch_conv_ref(*map(jnp.asarray, j_args))) \
        .astype(np.float32)
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


def test_row_tolerance_covers_summation_order(monkeypatch):
    """The kernels sum K in 64-deep tiles, the plain versions in one
    product, both rounding to bf16 at the same points: they differ by the
    roundings a summation order flips. At (2, 1024, 1024) the plain
    versions with 64-deep chunked sums stay within half the row limit
    that holds the kernels (``launch.monarch_fftconv.ROW_REL_L2``)."""
    from repro_torch.kernels.monarch_fft import ref
    m_args, c_args = M.make_inputs(2, 1024, 1024, torch.device("cpu"))
    want = ref.monarch_ref(*m_args), ref.monarch_conv_ref(*m_args, *c_args)

    def chunked(w, x):
        w, x = w.float(), x.float()
        return sum(torch.matmul(w[:, k:k + 64], x[..., k:k + 64, :])
                   for k in range(0, w.shape[1], 64))

    monkeypatch.setattr(ref, "_mm", chunked)
    got = ref.monarch_ref(*m_args), ref.monarch_conv_ref(*m_args, *c_args)
    errs = [M.row_rel_l2(g, w) for g, w in zip(got, want)]
    print(f"row relative L2 with 64-deep sums: monarch {errs[0]:.3e}, "
          f"conv {errs[1]:.3e}")
    assert 0 < errs[0] < errs[1] < M.ROW_REL_L2 / 2


def test_operational_intensity_matches_jax():
    for shape in ((16, 1024, 1024), (16, 256, 256), (4, 128, 512)):
        for level in ("none", "gemm0_mul_t", "full"):
            assert ops.operational_intensity(*shape, fusion=level) == \
                jax_oi(*shape, fusion=level)
    # Table I's ordering, and the conv's counts: two passes and the filter
    none, part, full = (ops.operational_intensity(16, 1024, 1024,
                                                  fusion=f)
                        for f in ("none", "gemm0_mul_t", "full"))
    assert none < part < full
    fl, nb = ops.monarch_flops_bytes(16, 1024, 1024)
    assert (fl, nb) == (68736253952, 73400320)
    cfl, cnb = ops.monarch_conv_flops_bytes(16, 1024, 1024)
    assert cfl == 2 * fl + 16 * 1024 * 1024
    assert cnb == 2 * 16 * 1024 * 1024 * 2 + 7 * 1024 * 1024 * 2


def test_showcase_runs_on_cpu(capsys):
    r = M.run(2, 128, 128, device="cpu")
    M.check(r)
    assert r["shape"] == (2, 128, 128) and r["device"] == "cpu"
    for name in ("monarch", "monarch_conv"):
        # on the CPU the wrappers are the plain versions
        assert r[name]["max_abs_err"] == 0.0
        assert r[name]["row_rel_l2"] == 0.0
        assert r[name]["row_tol"] == M.ROW_REL_L2
    assert min(r["fused_s"], r["plain_s"], r["unfused_s"]) > 0
    results = M.main(["--device", "cpu", "--shape", "1", "128", "256"])
    assert [x["shape"] for x in results] == [(1, 128, 256)]
    out = capsys.readouterr().out
    assert "Fully spatially fused" in out and "(16, 1024, 1024)" in out
    bad = dict(r, monarch=dict(r["monarch"], row_rel_l2=1.0))
    with pytest.raises(AssertionError, match="monarch"):
        M.check(bad)


def test_wrappers_raise_on_shapes_jax_refuses():
    # N1 = 192: the Pallas kernel asserts N1 % min(128, N1) == 0
    args = _inputs(1, 192, 128)
    with pytest.raises(AssertionError):
        jax_monarch(*map(jnp.asarray, args), interpret=True)
    with pytest.raises(ValueError, match="min\\(128, N1\\)"):
        ops.monarch(*map(torch.as_tensor, args))
    # factors that do not match x
    x, w0, tw, w1 = map(torch.as_tensor, _inputs(1, 128, 256))
    for bad in ((x, w0, tw, w0), (x, w1, tw, w1), (x, w0, tw.T, w1),
                (x[0], w0, tw, w1)):
        with pytest.raises(ValueError):
            ops.monarch(*bad)
    c = list(map(torch.as_tensor, _inputs(1, 128, 256, conv=True)))
    for i, wrong in ((4, c[4].T), (5, c[7]), (6, c[6].T), (7, c[5])):
        with pytest.raises(ValueError):
            ops.monarch_conv(*c[:i], wrong, *c[i + 1:])


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper sees when it
    is handed a card tensor on a machine where the kernel cannot run."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_never_reaches_the_plain_versions(monkeypatch):
    """Without a compiler the build raises, nothing launches, and the plain
    versions are never called; an f32 tensor raises TypeError before
    anything is built."""
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(ops, "monarch_ref", refuse)
    monkeypatch.setattr(ops, "monarch_conv_ref", refuse)
    monkeypatch.setattr(rt, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA kernels cannot be built")))
    monkeypatch.setattr(rt, "BUILD_DIR", pathlib.Path("/nonexistent"))
    for dtype, err, match in ((torch.bfloat16, RuntimeError, "nvcc not found"),
                              (torch.float32, TypeError, "bf16")):
        c = [torch.as_tensor(a).to(dtype).as_subclass(_CudaLooking)
             for a in _inputs(1, 128, 256, conv=True)]
        rt.reset_launches()
        with pytest.raises(err, match=match):
            ops.monarch(*c[:4])
        with pytest.raises(err, match=match):
            ops.monarch_conv(*c)
        assert rt.launch_counts()["monarch_fused"] == 0
        assert rt.launch_counts()["monarch_conv_fused"] == 0
