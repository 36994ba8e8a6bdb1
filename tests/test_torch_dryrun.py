"""The dry-run (``launch.dryrun``) on fake groups, each in a process of its
own (the fake group owns the default group, ``_torch_ranks.env``).

For a reduced config of every family (attention at the kernels' widths,
``reduced(..., full_heads=True)``, padded for a 2-wide model axis, 3 layer
units) x train / prefill / decode, traced on a fake (2, 2) and (1, 1)
group: every trace ends; the flops, bytes and collective bytes
extrapolated from 1 and 2 units (``loopfix.extrapolate``) equal the
3-unit trace's exactly (the trace counts every iteration of every loop:
no once-counted body is left to add back, as JAX's ``inner_corrections``
adds); the per-device flops at (2, 2) are no more than at (1, 1); the
useful-flops ratio is below JAX's bound of 1.6. The attention families
run at S 256 > 2 x 64, the reduced ``attn_chunk`` past which JAX's
trace counts its block loop once; xLSTM, which attends nothing, at S 16:
its sLSTM steps once per position (JAX counts one step), and the trace
runs every step's ops. The kernels a trace records are the step's
(``stepfn.kernel_launches`` for training).

``PerfOptions.moe_dispatch_constraint`` on the fake production group:
DeepSeek-V2-Lite's MoE buffers pinned by expert over 'model' and its
collectives by kind changed; Mixtral's (8 experts over 16) unchanged.

The CLI on a fake production group of 256: a decode cell ends ``ok``
with its terms, and a full-attention arch's ``long_500k`` is skipped."""
import json
import subprocess
import sys

import pytest

from _torch_ranks import ROOT, env

FAMILIES = {"samba-coe-expert-7b": 256, "mixtral-8x7b": 256,
            "deepseek-v2-lite-16b": 256, "whisper-small": 256,
            "recurrentgemma-9b": 256, "xlstm-1.3b": 16}
USEFUL_MAX = 1.6

TRACE = """
import json, logging, sys
from repro_torch.configs import ShapeCell, get_config, pad_for_tp, reduced
from repro_torch.distributed import stepfn
from repro_torch.launch import dryrun as D
from repro_torch.launch.loopfix import reduced_depth_cfg
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import RooflineTerms, model_flops_cell
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
arch, S = sys.argv[1], int(sys.argv[2])
cfg = pad_for_tp(reduced(get_config(arch), full_heads=True), 2)
out = {"launches": stepfn.kernel_launches(reduced_depth_cfg(cfg, 3))}
for shape in ((2, 2), (1, 1)):
    D.start_group(shape[0] * shape[1])
    mesh = make_mesh(shape, ("data", "model"), device=D.fake_devices()[1])
    for kind in ("train", "prefill", "decode"):
        cell = ShapeCell(kind, S, 4, kind)
        for u in ((1, 2, 3) if shape == (2, 2) else (3,)):
            c = reduced_depth_cfg(cfg, u)
            tr = D.trace_step(c, cell, mesh)
            coll = sum(D.collective_bytes(tr.coll).values())
            terms = RooflineTerms(arch, kind, str(shape), shape[0] * shape[1],
                                  tr.flops * shape[0] * shape[1],
                                  tr.bytes * shape[0] * shape[1], coll, {},
                                  model_flops_cell(c, cell))
            out[f"{shape}|{kind}|{u}"] = dict(
                flops=float(tr.flops), bytes=float(tr.bytes),
                coll=float(coll), kernels=tr.kernels, peak=tr.peak,
                args=tr.argument_bytes,
                useful=terms.useful_flops_ratio)
print(json.dumps(out))
"""


# PerfOptions.moe_dispatch_constraint in the dry-run: each serving and
# training cell of ``arch`` at one layer unit on the fake single-pod
# (16, 16) group, traced with the field off and on; every named placement
# the trace applies, and the collective bytes by kind
PIN_TRACE = """
import json, logging, sys
from repro_torch.configs import get_config, pad_for_tp
from repro_torch.distributed import ctx
from repro_torch.launch import dryrun as D
from repro_torch.launch.loopfix import reduced_depth_cfg
from repro_torch.launch.mesh import make_production_mesh
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
arch = sys.argv[1]
D.start_group(256)
mesh = make_production_mesh(multi_pod=False)
cfg = reduced_depth_cfg(pad_for_tp(get_config(arch), 16), 1)
pin, seen = ctx.constrain_named, []

def spy(name, t):
    out = pin(name, t)
    if name == "moe_dispatch":
        seen.append([list(t.shape), str(out.placements)])
    return out

ctx.constrain_named = spy
out = {}
for cell in ("train_4k", "prefill_32k", "decode_32k"):
    for on in (False, True):
        seen.clear()
        with ctx.perf_options(ctx.PerfOptions(moe_dispatch_constraint=on)):
            tr = D.trace_step(cfg, D._cell(cell), mesh)
        out[f"{cell}|{on}"] = dict(coll=D.collective_bytes(tr.coll),
                                   flops=float(tr.flops), seen=list(seen))
print(json.dumps(out))
"""


def _run(args, timeout):
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, env=env(), cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_dryrun_traces_every_family(arch):
    from repro_torch.launch.loopfix import extrapolate
    got = json.loads(_run(["-c", TRACE, arch, str(FAMILIES[arch])],
                          420).splitlines()[-1])
    launches = got.pop("launches")
    for kind in ("train", "prefill", "decode"):
        c1, c2, c3 = (got[f"(2, 2)|{kind}|{u}"] for u in (1, 2, 3))
        ext = extrapolate(c1, c2, 3)
        for k in ("flops", "bytes", "coll"):
            assert ext[k] == c3[k], (kind, k, ext[k], c3[k])
        one = got[f"(1, 1)|{kind}|3"]
        assert one["coll"] == 0.0, kind
        assert 0 < c3["flops"] <= one["flops"], kind
        assert 0 < c3["args"] <= c3["peak"], kind
        for rec in (c3, one):
            assert rec["useful"] < USEFUL_MAX, (kind, rec["useful"])
    # a training trace records the kernels one step of the 3-unit config
    # launches on the card; serving runs the forward kernel only
    want = {k: v for k, v in launches.items() if v}
    assert got["(1, 1)|train|3"]["kernels"] == want
    assert got["(2, 2)|train|3"]["kernels"] == want
    n_attn = launches["flash_prefill_bwd"]
    n_rec = launches["lru_scan_bwd"]
    assert got["(2, 2)|prefill|3"]["kernels"] == {
        k: v for k, v in (("flash_prefill", n_attn), ("lru_scan", n_rec))
        if v}
    assert got["(2, 2)|decode|3"]["kernels"] == {}


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_moe_dispatch_constraint_in_the_dryrun(arch):
    """DeepSeek-V2-Lite's 64 experts divide the 16-wide model axis: with
    the field on, the trace pins both MoE buffers (E, C, D) of each MoE
    layer by expert over 'model' (placements ``(Replicate(),
    Shard(dim=0))``), and the collective bytes by kind differ from the
    field off (PERF.md records both breakdowns). Mixtral's 8 experts do
    not divide it: JAX's condition leaves them unpinned, and every cell
    traces the same."""
    got = json.loads(_run(["-c", PIN_TRACE, arch], 420).splitlines()[-1])
    for cell in ("train_4k", "prefill_32k", "decode_32k"):
        off, on = got[f"{cell}|False"], got[f"{cell}|True"]
        assert off["seen"] == []
        if arch == "mixtral-8x7b":
            assert on == off, cell
            continue
        # one layer unit: the dense first layer, one MoE layer; its two
        # buffers, pinned in the forward (and its recomputation)
        E, D_ = 64, 2048
        assert on["seen"] and all(
            shape[0] == E and shape[2] == D_
            and pl == "(Replicate(), Shard(dim=0))"
            for shape, pl in on["seen"]), (cell, on["seen"])
        assert on["coll"] != off["coll"], cell


def test_dryrun_cli_on_a_production_group(tmp_path):
    path = tmp_path / "dryrun.json"
    for arch, cell in (("whisper-small", "decode_32k"),
                       ("granite-8b", "long_500k")):
        _run(["-m", "repro_torch.launch.dryrun", "--arch", arch, "--cell",
              cell, "--single-pod-only", "--results", str(path)], 240)
    d = json.loads(path.read_text())
    assert d["granite-8b|long_500k|single"]["status"] == "skipped"
    rec = d["whisper-small|decode_32k|single"]
    assert rec["status"] == "ok"
    r = rec["roofline"]
    assert r["chips"] == 256 and r["mesh"] == "single-pod(16,16)"
    assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
    assert r["collective_bytes"] > 0 and r["bottleneck"] == "memory"
    m = rec["memory"]
    assert 0 < m["argument_bytes_per_device"] <= m["peak_bytes_per_device"]
    assert "not measured" in rec["constants"]
