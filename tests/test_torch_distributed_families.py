"""RecurrentGemma, xLSTM and Whisper on a mesh on the CPU: gloo groups of 2
ranks (``_torch_ranks``), reduced configs (``pad_for_tp(..., 2)``) on
f32 params, against the port's single-device steps on the same params and
inputs.

For each family the two ranks run, on a (1, 2) mesh (TP 2: Megatron-SP
residuals in training, the recurrences and attention through
``local_map``) and then on a (2, 1) mesh (DP 2), two train steps of
``make_train_step(mesh=...)``, a prefill of ``make_prefill_step`` and
three greedy decode steps of ``make_decode_step``: each step's loss and
grad norm and the params after the second step (relative L2 over the
whole tree: Adam's first steps move a parameter whose gradient is nearly
zero by about the learning rate whatever that gradient's digits, as
xLSTM's input-gate biases) within ``F32_TOL_REL`` of the single-device
step's, the prefill's logits too, the decode steps' (which read bf16
caches) within ``CACHE_TOL_REL`` (xLSTM: everything within
``XLSTM_TOL_REL``); the prefill's cache in the step's cache placements,
and the greedy tokens equal."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_ranks import load, run_ranks, save
from repro_torch.bridge import tree_items, tree_map
from repro_torch.configs import get_config, pad_for_tp, reduced
from repro_torch.distributed import stepfn
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig

OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=4)
F32_TOL_REL = 1e-4
# the decode steps read bf16 caches (as every family's cache_spec makes
# them): an f32 difference in the prefill's last place can round a cache
# entry to the next bf16 value, 2^-8 of it
CACHE_TOL_REL = 1e-2
# xLSTM rounds to bf16 at JAX's points in f32 too (the per-head norm's
# output, the sLSTM's h before its recurrent product): TP 2 sums the
# projections in another order, and a value that lands on the other side
# of a bf16 rounding moves by 2^-8 of it. With those roundings taken out
# (f32 throughout) its TP 2 loss and gradients agree within 1e-4.
XLSTM_TOL_REL = 2e-2
N_DECODE = 3

# (arch, prompt length, max_len): RG's prompt passes its window of 32
FAMILIES = {"recurrentgemma-9b": (40, 48), "xlstm-1.3b": (16, 24),
            "whisper-small": (16, 24)}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(arch):
    cfg = pad_for_tp(reduced(get_config(arch)), 2)
    if cfg.family == "rglru":
        cfg = dataclasses.replace(cfg, n_layers=5)  # a group and the tail
    return cfg


def _rel(x, want):
    x, want = x.double(), want.double()
    return float((x - want).abs().max() / max(float(want.abs().max()), 1e-30))


def _rel_l2(x, want):
    x, want = x.double(), want.double()
    return float(torch.linalg.vector_norm(x - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-30))


def _inputs(cfg, S):
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, S + 1), generator=g)
    batch = {"tokens": toks[:, :-1].clone(), "targets": toks[:, 1:].clone()}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn(
            (4, cfg.encoder_seq, cfg.d_model), generator=g)
    return batch


def _single(cfg, params, batch, max_len):
    fn = stepfn.make_train_step(cfg, AdamWConfig(**OPT))
    state = stepfn.init_train_state(tree_map(torch.clone, params))
    metrics = []
    for _ in range(2):
        state, met = fn(state, batch)
        metrics.append((float(met["loss"]), float(met["grad_norm"])))
    m = get_model(cfg)
    pre = {k: v for k, v in batch.items() if k != "targets"}
    logits, cache = m.prefill(params, pre, max_len)
    out = [logits]
    pos = batch["tokens"].shape[1]
    for i in range(N_DECODE):
        logits, cache = m.decode_step(params, cache, out[-1].argmax(-1)[:, None],
                                      pos + i)
        out.append(logits)
    return metrics, dict(tree_items(state["params"])), out


RANKS = """
    from repro_torch.bridge import tree_items, tree_map
    from repro_torch.distributed import partitioning as part, stepfn
    from repro_torch.launch.mesh import make_mesh
    inp = torch.load(f"{TMP}/in.pt", weights_only=False)
    cfg, batch, max_len = inp["cfg"], inp["batch"], inp["max_len"]
    pre = {k: v for k, v in batch.items() if k != "targets"}
    for shape in ((1, 2), (2, 1)):
        mesh = make_mesh(shape, ("data", "model"))
        fn, sh, bsh = stepfn.make_train_step(cfg, inp["opt"], mesh=mesh)
        state = part.device_put(stepfn.init_train_state(
            tree_map(torch.clone, inp["params"])), sh)
        b = part.device_put(batch, bsh(batch))
        metrics = []
        for _ in range(2):
            state, met = fn(state, b)
            metrics.append((float(met["loss"]), float(met["grad_norm"])))
        params = {n: x.full_tensor() for n, x in tree_items(state["params"])}
        prefill, psh, csh = stepfn.make_prefill_step(cfg, mesh, max_len,
                                                     batch=4)
        decode, _, _ = stepfn.make_decode_step(cfg, mesh, batch=4,
                                               max_len=max_len)
        p = part.device_put(inp["params"], psh)
        logits, cache = prefill(p, pre)
        placed = [(n, str(x.placements), str(s.placements)) for (n, x), (_, s)
                  in zip(tree_items(cache), tree_items(csh))]
        out = [logits.full_tensor()]
        pos = batch["tokens"].shape[1]
        for i in range(3):
            logits, cache = decode(p, cache, out[-1].argmax(-1)[:, None],
                                   pos + i)
            out.append(logits.full_tensor())
        emit(f"mesh{shape[0]}x{shape[1]}", {"metrics": metrics,
             "params": params, "logits": out, "placed": placed})
"""


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_steps_on_mesh(tmp_path, arch):
    S, max_len = FAMILIES[arch]
    cfg = _cfg(arch)
    params = tree_map(lambda t: t.float(), get_model(cfg).init(
        torch.Generator().manual_seed(0), "cpu"))
    batch = _inputs(cfg, S)
    metrics, want_params, want_logits = _single(cfg, params, batch, max_len)
    save(tmp_path, {"cfg": cfg, "params": params, "batch": batch,
                    "max_len": max_len, "opt": AdamWConfig(**OPT)})
    run_ranks(RANKS, 2, tmp_path)
    tol, cache_tol = (XLSTM_TOL_REL,) * 2 if cfg.family == "xlstm" \
        else (F32_TOL_REL, CACHE_TOL_REL)
    names = sorted(want_params)
    for shape in ("mesh1x2", "mesh2x1"):
        got = [load(tmp_path, shape, r) for r in range(2)]
        assert got[0]["metrics"] == got[1]["metrics"], shape
        for (l, g), (wl, wg) in zip(got[0]["metrics"], metrics):
            assert abs(l - wl) / abs(wl) < tol, (shape, l, wl)
            assert abs(g - wg) / abs(wg) < tol, (shape, g, wg)
        err = _rel_l2(torch.cat([got[0]["params"][n].reshape(-1)
                                 for n in names]),
                      torch.cat([want_params[n].reshape(-1) for n in names]))
        assert err < tol, (shape, err)
        for i, (x, want) in enumerate(zip(got[0]["logits"], want_logits)):
            assert _rel(x, want) < (cache_tol if i else tol), \
                (shape, i, _rel(x, want))
            assert torch.equal(x.argmax(-1), want.argmax(-1)), (shape, i)
        for name, have, want in got[0]["placed"]:
            assert have == want, (shape, name, have, want)
