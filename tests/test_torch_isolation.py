"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or anything of the JAX package, and a CUDA tensor handed to a
kernel wrapper is never sent to the plain version."""
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)\b(?!_)", re.M)


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _IMPORT.search(f.read_text())]
    assert offenders == []


def test_every_module_imports_with_jax_and_repro_refused():
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("refused: " + name)
        for m in list(sys.modules):
            if m.split(".")[0] in ("jax", "jaxlib", "repro"):
                del sys.modules[m]
        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(ROOT / 'src')!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(ROOT / 'chip_smoke.py')!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper sees when it
    is handed a card tensor on a machine where the kernel cannot run."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(shape, dtype=torch.bfloat16, value=None):
    t = torch.zeros(shape, dtype=dtype) if value is None else value
    return t.as_subclass(_CudaLooking)


@pytest.mark.parametrize("kernel", ["decode_paged", "qkv_rope_paged",
                                    "oproj_ffn_swiglu"])
def test_cuda_tensor_never_falls_back_to_the_plain_version(kernel,
                                                           monkeypatch):
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.flash_attention.ops import decode_paged
    from repro_torch.kernels.fused_decode.ops import (oproj_ffn_swiglu,
                                                      qkv_rope_paged)

    def refuse_plain(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(
        "repro_torch.kernels.flash_attention.ops.decode_paged_ref",
        refuse_plain)
    monkeypatch.setattr(
        "repro_torch.kernels.fused_decode.ops.qkv_rope_paged_ref",
        refuse_plain)
    monkeypatch.setattr(
        "repro_torch.kernels.fused_decode.ops.oproj_ffn_swiglu_ref",
        refuse_plain)
    # no compiler here: the build raises, and nothing is written
    monkeypatch.setattr(rt, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA kernels cannot be built")))
    monkeypatch.setattr(rt, "BUILD_DIR", pathlib.Path("/nonexistent"))
    i32 = torch.int32
    if kernel == "decode_paged":
        call = lambda: decode_paged(
            _cuda_looking((2, 4, 32)), _cuda_looking((5, 8, 4, 32)),
            _cuda_looking((5, 8, 4, 32)), _cuda_looking((2, 2), i32),
            _cuda_looking((2,), i32, torch.ones(2, dtype=i32)))
    elif kernel == "qkv_rope_paged":
        call = lambda: qkv_rope_paged(
            _cuda_looking((2, 64)), _cuda_looking((64,)),
            _cuda_looking((64, 4, 32)), _cuda_looking((64, 2, 32)),
            _cuda_looking((64, 2, 32)), _cuda_looking((2,), i32))
    else:
        call = lambda: oproj_ffn_swiglu(
            _cuda_looking((2, 64)), _cuda_looking((2, 128)),
            _cuda_looking((128, 64)), _cuda_looking((64,)),
            _cuda_looking((64, 96)), _cuda_looking((64, 96)),
            _cuda_looking((96, 64)))
    rt.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call()
    assert rt.launch_counts()[kernel] == 0


def test_cuda_f32_tensor_raises_instead_of_falling_back(monkeypatch):
    """The kernels take bf16 only: an f32 tensor on the card raises before
    anything is built, and never reaches the plain version."""
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.flash_attention.ops import decode_paged
    from repro_torch.kernels.fused_decode.ops import (oproj_ffn_swiglu,
                                                      qkv_rope_paged)

    def refuse(*a, **k):
        raise AssertionError("plain version or build reached")

    for name in ("flash_attention.ops.decode_paged_ref",
                 "fused_decode.ops.qkv_rope_paged_ref",
                 "fused_decode.ops.oproj_ffn_swiglu_ref",
                 *_DENSE_PLAIN, *_PREFILL_PLAIN):
        monkeypatch.setattr(f"repro_torch.kernels.{name}", refuse)
    monkeypatch.setattr(rt, "bind", refuse)
    f32, i32 = torch.float32, torch.int32
    calls = [
        lambda: decode_paged(
            _cuda_looking((2, 4, 32), f32), _cuda_looking((5, 8, 4, 32), f32),
            _cuda_looking((5, 8, 4, 32), f32), _cuda_looking((2, 2), i32),
            _cuda_looking((2,), i32, torch.ones(2, dtype=i32))),
        lambda: qkv_rope_paged(
            _cuda_looking((2, 64), f32), _cuda_looking((64,), f32),
            _cuda_looking((64, 4, 32), f32), _cuda_looking((64, 2, 32), f32),
            _cuda_looking((64, 2, 32), f32), _cuda_looking((2,), i32)),
        lambda: oproj_ffn_swiglu(
            _cuda_looking((2, 64), f32), _cuda_looking((2, 128), f32),
            _cuda_looking((128, 64), f32), _cuda_looking((64,), f32),
            _cuda_looking((64, 96), f32), _cuda_looking((64, 96), f32),
            _cuda_looking((96, 64), f32)),
        *_dense_calls(f32).values(),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="bf16"):
            call()
    # the prefill kernels each given the other's type: flash_prefill takes
    # bf16 only, lru_scan f32 only
    for call in _prefill_calls(wrong_dtype=True).values():
        with pytest.raises(TypeError, match="the kernel takes (bf16|f32)"):
            call()


# the dense-cache decode kernels: wrapper -> its plain version in ``ops``
_DENSE_PLAIN = ("flash_attention.ops.decode_attention_ref",
                "fused_decode.ops.qkv_rope_ref",
                "fused_decode.ops.ffn_swiglu_ref")


def _dense_calls(dtype=torch.bfloat16):
    """One call of each dense-cache kernel wrapper on CUDA-looking tensors,
    keyed by its launch-count name."""
    from repro_torch.kernels.flash_attention.ops import decode
    from repro_torch.kernels.fused_decode.ops import ffn_swiglu, qkv_rope
    c = lambda *shape: _cuda_looking(shape, dtype)
    return {
        "flash_decode": lambda: decode(c(2, 4, 32), c(2, 16, 2, 32),
                                       c(2, 16, 2, 32), 5),
        "qkv_rope": lambda: qkv_rope(c(2, 64), c(64,), c(64, 8 * 32), 3,
                                     n_q=4, n_kv=2, dh=32, rope_frac=0.5),
        "ffn_swiglu": lambda: ffn_swiglu(c(2, 64), c(64,), c(64, 96),
                                         c(64, 96), c(96, 64),
                                         residual=False),
    }


# the prefill kernels: wrapper -> its plain version in ``ops``
_PREFILL_PLAIN = ("flash_attention.ops.attention_ref",
                  "lru_scan.ops.lru_scan_ref")


def _prefill_calls(wrong_dtype=False):
    """One call of each prefill kernel wrapper on CUDA-looking tensors of
    the kernel's type (bf16 attention, f32 recurrence), or each of the
    other's type, keyed by its launch-count name."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.lru_scan.ops import lru_scan
    at, lt = torch.bfloat16, torch.float32
    if wrong_dtype:
        at, lt = lt, at
    return {
        "flash_prefill": lambda: attention(
            _cuda_looking((2, 16, 4, 32), at), _cuda_looking((2, 16, 2, 32), at),
            _cuda_looking((2, 16, 2, 32), at), causal=True, window=8),
        "lru_scan": lambda: lru_scan(_cuda_looking((2, 16, 64), lt),
                                     _cuda_looking((2, 16, 64), lt)),
    }


def test_cuda_tensor_never_reaches_the_dense_plain_versions(monkeypatch):
    """As above for ``decode``, ``qkv_rope``, ``ffn_swiglu`` and the prefill
    kernels ``flash_prefill`` and ``lru_scan``: without a compiler the build
    raises, nothing launches, and the plain versions are never called."""
    from repro_torch.kernels import runtime as rt

    def refuse_plain(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in _DENSE_PLAIN + _PREFILL_PLAIN:
        monkeypatch.setattr(f"repro_torch.kernels.{name}", refuse_plain)
    monkeypatch.setattr(rt, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA kernels cannot be built")))
    monkeypatch.setattr(rt, "BUILD_DIR", pathlib.Path("/nonexistent"))
    for kernel, call in {**_dense_calls(), **_prefill_calls()}.items():
        rt.reset_launches()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
        assert rt.launch_counts()[kernel] == 0


def test_mixed_devices_raise():
    from repro_torch.kernels.runtime import on_card
    with pytest.raises(ValueError, match="mixed"):
        on_card(torch.zeros(1), _cuda_looking((1,)))
    assert on_card(torch.zeros(1), torch.ones(2)) is False
