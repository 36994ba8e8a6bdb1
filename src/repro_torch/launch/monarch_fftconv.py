"""Monarch FFT-conv showcase of the port (paper Fig. 3-4, Table I):
``python -m repro_torch.launch.monarch_fftconv``.

Prints the Table I operational-intensity ledger of the Fig-3 pipeline
(Gemm0 -> Mul(twiddle) -> Transpose -> Gemm1) at the 1M-point shape
(16, 1024, 1024) and at (16, 256, 256), then at both shapes runs the fused
Monarch pass (``monarch``) and the fused FFT-conv (``monarch_conv``:
monarch, pointwise filter, inverse monarch) against their plain versions,
and times the conv three ways: the kernels, the one-expression plain chain
(``monarch_conv_ref``), and op by op (``monarch_unfused_ref``, the filter,
``monarch_unfused_ref``, each step finished before the next is issued).
For example, on one H100:

    python -m repro_torch.launch.monarch_fftconv

and on the host, where the kernels' plain versions run at a small shape:

    python -m repro_torch.launch.monarch_fftconv --device cpu --shape 2 128 128

Inputs are bf16, drawn from ``--seed`` on the device: x and the twiddles
and filter N(0, 1), each factor matrix N(0, 1) / sqrt(its size).
"""
from __future__ import annotations

import argparse
import time

import torch

# the shapes of the paper's 1M-point Monarch and of the JAX benchmark's
# Table I ledger (benchmarks/run.py::bench_table1_intensity)
TABLE1_SHAPES = ((16, 1024, 1024), (16, 256, 256))
FUSION_LEVELS = (("none", "No fusion"),
                 ("gemm0_mul_t", "Gemm0-Mul-Transpose"),
                 ("full", "Fully spatially fused"))
# Kernel against plain version, bf16 outputs. Both accumulate in f32 and
# round at the same points, so they differ by summation order and the rare
# bf16 rounding it flips: max |err| within two units in the last place of
# max(1, max |plain|) (2^-7 of it), and each output row (the last axis)
# within 2^-8 relative L2. The plain versions with their sums split into
# 64-deep chunks, as the kernels split them, read 5.8e-4 (monarch) and
# 1.4e-3 (conv) row error at (2, 1024, 1024)
# (tests/test_torch_monarch.py::test_row_tolerance_covers_summation_order);
# the kernels read 8.3e-4 and 2.1e-3 on an H100 at (16, 1024, 1024), where
# a dropped twiddle reads 1.56 and one N1 block zeroed or the last 64 of K
# skipped 0.34 (chip_smoke.py's planted faults).
MAX_ABS_REL = 2.0 ** -7
ROW_REL_L2 = 2.0 ** -8


def row_rel_l2(got, want):
    """The largest ||got - want|| / ||want|| over the rows of the last
    axis."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-30)).max())


def make_inputs(B, N1, N2, device, seed=0, dtype=torch.bfloat16):
    """The example's inputs: ``(x, w0, tw, w1)`` of the Monarch pass and
    ``(filt, w0i, twi, w1i)`` of the conv, from a seeded generator on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    x = rnd(B, N1, N2)
    w0, tw, w1 = rnd(N1, N1, scale=N1 ** -0.5), rnd(N1, N2), \
        rnd(N2, N2, scale=N2 ** -0.5)
    filt, w0i, twi, w1i = rnd(N2, N1), rnd(N2, N2, scale=N2 ** -0.5), \
        rnd(N2, N1), rnd(N1, N1, scale=N1 ** -0.5)
    return (x, w0, tw, w1), (filt, w0i, twi, w1i)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mean_s(fn, device, reps):
    """Mean host seconds of ``fn`` run to completion, after one warm-up."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        _sync(device)
    return (time.perf_counter() - t0) / reps


def _errors(got, want):
    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite output")
    err = float((got.float() - want.float()).abs().max())
    return dict(max_abs_err=err, row_rel_l2=row_rel_l2(got, want),
                max_abs_tol=MAX_ABS_REL * max(1.0,
                                              float(want.float().abs().max())),
                row_tol=ROW_REL_L2)


def run(B, N1, N2, *, device=None, seed=0, reps=5):
    """``monarch`` and ``monarch_conv`` at (B, N1, N2) against their plain
    versions, and the conv timed as the kernels, the one-expression plain
    chain and the op-by-op chain. Returns a dict: each function's errors
    (``max_abs_err``, ``row_rel_l2``, and the tolerances they are held to
    by ``check``) and the three mean seconds. Nothing is checked here."""
    from repro_torch import resolve_device
    from repro_torch.kernels.monarch_fft import ref
    from repro_torch.kernels.monarch_fft.ops import monarch, monarch_conv

    dev = resolve_device(device)
    m_args, c_args = make_inputs(B, N1, N2, dev, seed)
    conv_args = m_args + c_args
    filt, w0i, twi, w1i = c_args
    out = dict(shape=(B, N1, N2), device=str(dev),
               monarch=_errors(monarch(*m_args), ref.monarch_ref(*m_args)),
               monarch_conv=_errors(monarch_conv(*conv_args),
                                    ref.monarch_conv_ref(*conv_args)))

    def unfused():
        f = ref.monarch_unfused_ref(*m_args)
        _sync(dev)
        f = f * filt
        _sync(dev)
        return ref.monarch_unfused_ref(f, w0i, twi, w1i)

    out["fused_s"] = _mean_s(lambda: monarch_conv(*conv_args), dev, reps)
    out["plain_s"] = _mean_s(lambda: ref.monarch_conv_ref(*conv_args), dev,
                             reps)
    out["unfused_s"] = _mean_s(unfused, dev, reps)
    return out


def check(result):
    """Raises if an error of ``run``'s result is above its tolerance."""
    for name in ("monarch", "monarch_conv"):
        e = result[name]
        if not (e["max_abs_err"] <= e["max_abs_tol"]
                and e["row_rel_l2"] <= e["row_tol"]):
            raise AssertionError(f"{name} at {result['shape']}: {e}")


def ledger_lines(B, N1, N2):
    from repro_torch.kernels.monarch_fft.ops import operational_intensity
    return [f"  {label:24s} "
            f"{operational_intensity(B, N1, N2, fusion=level):8.1f} "
            f"flops/byte" for level, label in FUSION_LEVELS]


def report(r):
    """``run``'s result as lines of text."""
    lines = []
    for name in ("monarch", "monarch_conv"):
        e = r[name]
        lines.append(f"  {name:12s} vs plain: max_err={e['max_abs_err']:.3e} "
                     f"(tol {e['max_abs_tol']:.3e}) row_rel_l2="
                     f"{e['row_rel_l2']:.3e} (tol {e['row_tol']:.3e})")
    lines.append(f"  FFT-conv: kernels {r['fused_s'] * 1e3:.4f} ms, "
                 f"one-expression plain {r['plain_s'] * 1e3:.4f} ms, "
                 f"op-by-op {r['unfused_s'] * 1e3:.4f} ms -> op-by-op / "
                 f"kernels {r['unfused_s'] / r['fused_s']:.2f}x")
    return lines


def main(argv=None):
    """Prints the ledger and each shape's report; raises if an error is
    above its tolerance. Returns ``run``'s results."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shape", type=int, nargs=3, action="append",
                    metavar=("B", "N1", "N2"),
                    help="run at this shape (repeatable); default: the "
                         "Table I shapes")
    args = ap.parse_args(argv)
    results = []
    for B, N1, N2 in TABLE1_SHAPES:
        print(f"Table I - operational intensity of the Fig-3 pipeline "
              f"({B}, {N1}, {N2}), bf16:")
        print("\n".join(ledger_lines(B, N1, N2)))
    for shape in args.shape or TABLE1_SHAPES:
        r = run(*shape, device=args.device, seed=args.seed)
        print(f"\n{tuple(shape)} on {r['device']}:")
        print("\n".join(report(r)))
        check(r)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
