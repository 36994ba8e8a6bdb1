"""Production dry-run (counterpart of ``repro.launch.dryrun``): trace every
(arch x shape x mesh) cell's real step on fake tensors over a fake process
group of 256 or 512 ranks, and record its per-device memory, its flops
and bytes and its collective bytes as roofline terms, modelled with the
data-sheet constants of the H100 80GB HBM3 at 700 W (``launch.roofline``),
not measured.

For each cell this builds the step that training and serving run
(``distributed.stepfn.make_train_step(mesh=...)``, ``make_prefill_step``,
``make_decode_step``) on ``launch.mesh.make_production_mesh`` over a fake
group (``torch.testing``'s ``FakeStore``: every collective returns
without moving data), hands it fake tensors (``FakeTensor``: a shape and
a type, no data) in the shardings the step names, with the configs padded
by ``pad_for_tp(cfg, 16)`` as JAX pads them, and runs it once. A trace
(``Trace``, a ``FakeTensorMode``) sees each op of rank 0 on its local
shard and counts:

  * flops: the registry's formula (``torch.utils.flop_counter``) of each
    local aten op, plus each kernel call's cost function (the wrappers'
    fake branch, ``kernels.runtime.traced``);
  * bytes: each local op's inputs and outputs (views and allocations
    aside), plus each kernel's bytes: the unfused upper bound, as XLA's
    'bytes accessed' is;
  * collective bytes by kind: the result bytes of each
    ``_c10d_functional`` collective (``wait_tensor`` skipped, as JAX
    skips an op's ``-done``);
  * argument and output bytes (the local shards), and the peak of the
    bytes live in fake storages over the trace.

DTensor runs its sharding propagation on fake tensors of the global
shapes too, once per cache miss; those runs are not counted. The counts
are rank 0's, globalised by the chips as JAX's are. On a torch built
without CUDA the fake tensors lie on the meta device (such a build has no
device guard for CUDA, which autograd and Python indexing need) and the
mesh on the CPU; the kernel wrappers take fake tensors there as the
card's (``runtime.on_card``).

Usage (the fake group owns the process's default group, so each call is
a process of its own):
    python -m repro_torch.launch.dryrun --arch mixtral-8x7b --cell decode_32k
    python -m repro_torch.launch.dryrun --all --correct   # every cell, both meshes
    python -m repro_torch.launch.dryrun --arch ... --multi-pod-only

Records go to ``results/dryrun_torch.json`` (``--results``) under
``arch|cell|single`` / ``arch|cell|multi``, each as it is made (several
dry-runs may share the file); ``--correct`` adds the two-point depth extrapolation
(``launch.loopfix``). ``--force`` traces (and corrects) a recorded cell
again.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ARCH_IDS, SHAPE_CELLS, cell_applicable,
                                 get_config, pad_for_tp)
from repro_torch.distributed import ctx
from repro_torch.distributed import partitioning as part
from repro_torch.distributed import stepfn
from repro_torch.kernels import runtime as rt
from repro_torch.launch.loopfix import corrected_cell_costs
from repro_torch.launch.roofline import (RooflineTerms, collective_bytes,
                                         model_flops_cell)
from repro_torch.models import get_model

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch.json"

# ops that move no data: an allocation, or a result that aliases its input
# (and the ``prim`` namespace's metadata queries)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "wait_tensor", "set_"}


def fake_devices():
    """(the fake tensors' device, the mesh's device type): the card's where
    this torch is built with CUDA, else the meta device on a CPU mesh."""
    if torch.backends.cuda.is_built():
        return "cuda", "cuda"
    return "meta", "cpu"


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out):
    """The tensors of an op's arguments or result (tensors, and lists or
    tuples of them, one level deep as the ATen schemas nest them)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            if isinstance(y, torch.Tensor):
                out.append(y)
            elif isinstance(y, (list, tuple)):
                _tensors(y, out)
    return out


class Trace(FakeTensorMode):
    """A fake mode that counts rank 0's local ops while ``on``: flops,
    bytes, collectives, kernel calls and live storage bytes (see the
    module's docstring)."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.on = False
        self.flops = 0
        self.bytes = 0
        self.coll = []                 # (op name, result bytes)
        self.kernels = {}              # kernel name -> calls
        self.live = 0
        self.peak = 0
        self._depth = 0
        self._prop = 0
        self._seen = set()

    # -- storages
    def hold(self, t, nbytes=None):
        """Count ``t``'s storage live until it is freed (once a
        storage)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes() if nbytes is None else nbytes
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    # -- counting
    def kernel(self, name, flops, nbytes):
        if self.on and not self._prop:
            self.flops += flops
            self.bytes += nbytes
            self.kernels[name] = self.kernels.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if (self.on and not self._prop and self._depth == 0
                and out is not NotImplemented):
            self._count(func, args, kwargs or {}, out)
        return out

    def _count(self, func, args, kwargs, out):
        outs = _tensors(out, [])
        name = func._opname
        if func.namespace == "_c10d_functional":
            if name != "wait_tensor":
                self.coll.append((name, sum(_nbytes(t) for t in outs)))
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view and name not in _NO_BYTES \
                and func.namespace != "prim":
            ins = _tensors(args, _tensors(list(kwargs.values()), []))
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            if isinstance(t, FakeTensor):
                self.hold(t)


class _DTensorInternals:
    """While entered: DTensor's sharding propagation (its runs on fake
    tensors of the global shapes) marks the trace so that it does not
    count them, and ``_StridedShard``'s shard offsets, which it computes
    with real index tensors and reads back, run outside the fake mode."""

    def __init__(self, trace):
        from torch.distributed.tensor import placement_types
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self.trace = trace
        # the propagation on a cache miss (its strategies, decompositions
        # and output metadata), under the names this torch has
        self.patches = [(ShardingPropagator, name, self._uncounted)
                        for name in ("propagate_op_sharding_non_cached",
                                     "_propagate_tensor_meta_non_cached")
                        if hasattr(ShardingPropagator, name)]
        strided = getattr(placement_types, "_StridedShard", None)
        if strided is not None and hasattr(strided,
                                           "local_shard_size_and_offset"):
            self.patches.append((strided, "local_shard_size_and_offset",
                                 self._unfaked))
        self.saved = []

    def _uncounted(self, real):
        trace = self.trace

        def wrapped(*a, **kw):
            trace._prop += 1
            try:
                return real(*a, **kw)
            finally:
                trace._prop -= 1
        return wrapped

    @staticmethod
    def _unfaked(real):
        from torch.utils._python_dispatch import _disable_current_modes

        def wrapped(*a, **kw):
            with _disable_current_modes():
                return real(*a, **kw)
        return wrapped

    def __enter__(self):
        import inspect
        for cls, name, wrap in self.patches:
            raw = inspect.getattr_static(cls, name)
            self.saved.append((cls, name, raw))
            if isinstance(raw, staticmethod):
                setattr(cls, name, staticmethod(wrap(raw.__func__)))
            else:
                setattr(cls, name, wrap(raw))

    def __exit__(self, *exc):
        for cls, name, raw in reversed(self.saved):
            setattr(cls, name, raw)
        self.saved.clear()


def _fake_dtensor(value, sharding, dev):
    """A DTensor of ``value``'s global shape and type, placed by
    ``sharding`` (fitted to the shape), whose local shard is a fresh fake
    tensor on ``dev``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes
    mesh = sharding.mesh
    spec = part.fit_pspec(tuple(value.shape), sharding.spec, mesh)
    pl = part.placements(spec, mesh)
    with _disable_current_modes():     # it reads the mesh's coordinates
        local_shape, _ = compute_local_shape_and_global_offset(
            tuple(value.shape), mesh, pl)
    local = torch.empty(local_shape, dtype=value.dtype, device=dev)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=value.shape,
                              stride=torch.empty(value.shape,
                                                 device="meta").stride())


def _fake_tree(tree, dev):
    if isinstance(tree, stepfn.Abstract):
        return _fake_dtensor(tree.value, tree.sharding, dev)
    return {k: _fake_tree(v, dev) for k, v in tree.items()}


def _fake_batch(specs, mesh, dev):
    sh = part.shardings_from_pspecs(
        part.batch_pspecs(None, specs, mesh), mesh)
    return {k: _fake_dtensor(v, sh[k], dev) for k, v in specs.items()}


def _locals(tree):
    return [x.to_local() if hasattr(x, "to_local") else x
            for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def trace_step(cfg, cell, mesh):
    """Trace ``cell``'s step of ``cfg`` on ``mesh`` once; returns the
    ``Trace`` with its counts, and the argument and output bytes of rank
    0's shards."""
    dev, _ = fake_devices()
    model = get_model(cfg)
    B, S = cell.global_batch, cell.seq_len
    trace = Trace()
    # PerfOptions.moe_dispatch_constraint: the MoE buffers by expert over
    # 'model', named as JAX's _lower_for names them
    with trace, rt.cost_hook(trace.kernel), _DTensorInternals(trace), \
            ctx.named_shardings(**ctx.moe_dispatch_named(cfg, mesh)):
        if cell.kind == "train":
            fn, _, _ = stepfn.make_train_step(cfg, mesh=mesh)
            args = (_fake_tree(stepfn.abstract_train_state(cfg, mesh), dev),
                    _fake_batch(model.input_specs(cell), mesh, dev))
        elif cell.kind == "prefill":
            fn, _, _ = stepfn.make_prefill_step(cfg, mesh, S + 128, batch=B)
            args = (_fake_tree(stepfn.abstract_train_state(
                cfg, mesh)["params"], dev),
                _fake_batch(model.input_specs(cell), mesh, dev))
        else:
            fn, _, _ = stepfn.make_decode_step(cfg, mesh, batch=B,
                                               max_len=S)
            # a full cache: the token at the last position attends all S
            args = (_fake_tree(stepfn.abstract_train_state(
                cfg, mesh)["params"], dev),
                _fake_tree(stepfn.abstract_cache(cfg, mesh, B, S), dev),
                _fake_batch(model.input_specs(cell), mesh, dev)["tokens"],
                S - 1)
        arg_locals = _locals(args)
        for t in arg_locals:
            trace.hold(t, _nbytes(t))
        trace.on = True
        out = fn(*args)
        trace.on = False
        out_locals = _locals(out)
    trace.argument_bytes = sum(_nbytes(t) for t in arg_locals)
    trace.output_bytes = sum(_nbytes(t) for t in out_locals)
    return trace


def _chips(mesh) -> int:
    n = 1
    for s in mesh.shape:
        n *= int(s)
    return n


def _mesh_name(multi_pod: bool) -> str:
    return "multi-pod(2,16,16)" if multi_pod else "single-pod(16,16)"


def _cell(name):
    return next(c for c in SHAPE_CELLS if c.name == name)


def lower_cell(arch: str, cell_name: str, mesh, *, verbose: bool = True):
    """Trace one cell at its arch's full depth on ``mesh``; its record."""
    multi_pod = mesh.ndim == 3
    cell = _cell(cell_name)
    cfg = pad_for_tp(get_config(arch), 16)
    ok, why = cell_applicable(cfg, cell)
    if not ok:
        return {"status": "skipped", "reason": why}
    t0 = time.time()
    tr = trace_step(cfg, cell, mesh)
    trace_s = time.time() - t0
    chips = _chips(mesh)
    coll = collective_bytes(tr.coll)
    terms = RooflineTerms(
        arch=arch, cell=cell_name, mesh=_mesh_name(multi_pod), chips=chips,
        hlo_flops=float(tr.flops) * chips,
        hlo_bytes=float(tr.bytes) * chips,
        collective_bytes=float(sum(coll.values())) * chips,
        collective_breakdown=coll,
        model_flops=model_flops_cell(cfg, cell),
        per_device_peak_bytes=float(tr.peak))
    rec = {
        "status": "ok",
        "trace_s": round(trace_s, 1),
        "memory": {"argument_bytes_per_device": tr.argument_bytes,
                   "output_bytes_per_device": tr.output_bytes,
                   "peak_bytes_per_device": tr.peak},
        "kernels": dict(tr.kernels),
        "roofline": terms.as_dict(),
        "constants": "H100 80GB HBM3 SXM at 700 W, data sheet; modelled "
                     "on fake tensors, not measured",
    }
    if verbose:
        print(f"[{arch} x {cell_name} x {terms.mesh}] trace={trace_s:.1f}s")
        print(f"  memory: args={tr.argument_bytes / 2**30:.2f}GiB"
              f" peak={tr.peak / 2**30:.2f}GiB"
              f" out={tr.output_bytes / 2**30:.2f}GiB /device")
        print(f"  trace: flops={terms.hlo_flops:.3e}"
              f" bytes={terms.hlo_bytes:.3e}"
              f" coll_bytes={terms.collective_bytes:.3e} kernels={tr.kernels}")
        _print_terms("  roofline:", terms)
    return rec


def _print_terms(label, terms):
    print(f"{label} compute={terms.compute_s * 1e3:.2f}ms"
          f" memory={terms.memory_s * 1e3:.2f}ms"
          f" collective={terms.collective_s * 1e3:.2f}ms"
          f" -> {terms.bottleneck}-bound"
          f" useful={terms.useful_flops_ratio:.2f}"
          f" roofline_frac={terms.roofline_fraction:.3f}")


def trace_cost(cfg, cell, mesh):
    """Per-device ``flops``, ``bytes``, ``coll`` of one trace of ``cfg``
    (any depth), for ``loopfix``."""
    tr = trace_step(cfg, cell, mesh)
    return {"flops": float(tr.flops), "bytes": float(tr.bytes),
            "coll": float(sum(collective_bytes(tr.coll).values())),
            "chips": _chips(mesh)}


def correct_cell(arch: str, cell_name: str, mesh, rec: dict, *,
                 verbose=True):
    """Attach the terms extrapolated from 1 and 2 layer units to an 'ok'
    record (``loopfix.corrected_cell_costs``); the full-depth trace's terms
    move to ``roofline_raw``."""
    cell = _cell(cell_name)
    cfg = pad_for_tp(get_config(arch), 16)
    out = corrected_cell_costs(cfg, cell, mesh.ndim == 3,
                               lambda c, x, _: trace_cost(c, x, mesh))
    raw = rec.get("roofline_raw", rec["roofline"])
    chips = raw["chips"]
    terms = RooflineTerms(
        arch=arch, cell=cell_name, mesh=raw["mesh"], chips=chips,
        hlo_flops=out["flops"] * chips, hlo_bytes=out["bytes"] * chips,
        collective_bytes=out["coll"] * chips,
        collective_breakdown=raw["collective_breakdown"],
        model_flops=model_flops_cell(cfg, cell),
        per_device_peak_bytes=raw.get("per_device_peak_bytes"))
    rec["roofline_raw"] = raw
    rec["roofline"] = terms.as_dict()
    rec["loopfix"] = {k: out[k] for k in ("flops_body", "bytes_body",
                                          "coll_body", "units")}
    if verbose:
        _print_terms(f"[corrected {arch} x {cell_name} x {terms.mesh}]",
                     terms)
    return rec


def start_group(world: int):
    """This process's default group: a fake one of ``world`` ranks, this
    process rank 0 (any earlier group is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(multi_pod: bool):
    """A fake group of 256 / 512 ranks and the production mesh on it."""
    from repro_torch.launch.mesh import make_production_mesh
    start_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod,
                                device=fake_devices()[1])


def _load(path):
    if path.exists():
        return json.loads(path.read_text())
    return {}


def _save(path, key, rec):
    """Write ``rec`` under ``key`` into the records at ``path``, read
    afresh under a lock: several dry-runs may write one file at once."""
    import fcntl
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        d = _load(path)
        d[key] = rec
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(d, indent=1, default=str))
        tmp.replace(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--correct", action="store_true",
                    help="add the terms extrapolated from 1 and 2 layer "
                         "units to ok cells (tracing a cell first where it "
                         "has no record)")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results", type=Path, default=RESULTS,
                    help="the records' file (default: %(default)s)")
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    if not (args.all or args.arch):
        ap.error("name an --arch (and a --cell), or --all")

    results = _load(args.results)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    cells = [args.cell] if args.cell else [c.name for c in SHAPE_CELLS]
    meshes = [False, True]
    if args.multi_pod_only:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]

    failures = []
    for mp in meshes:
        mesh = production_mesh(mp)
        for arch in archs:
            for cell in cells:
                key = f"{arch}|{cell}|{'multi' if mp else 'single'}"
                rec = results.get(key)
                if rec and rec.get("status") in ("ok", "skipped") \
                        and not args.force:
                    print(f"[cached] {key}: {rec['status']}")
                else:
                    try:
                        rec = lower_cell(arch, cell, mesh)
                    except Exception as e:
                        traceback.print_exc()
                        rec = {"status": "error",
                               "error": f"{type(e).__name__}: {e}"}
                        failures.append(key)
                    results[key] = rec
                    _save(args.results, key, rec)
                if args.correct and rec.get("status") == "ok" and (
                        "loopfix" not in rec or args.force):
                    try:
                        rec = correct_cell(arch, cell, mesh, rec)
                    except Exception:
                        traceback.print_exc()
                        failures.append(key)
                    results[key] = rec
                    _save(args.results, key, rec)
    dist.destroy_process_group()
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("dry-run complete:", len(results), "cells recorded in",
          args.results.name)


if __name__ == "__main__":
    main()
