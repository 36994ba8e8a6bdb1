"""The dry-run's cost models against the JAX package's, exactly, on the
same configs: the config predicates and parameter counts (every config of
``CONFIGS``, and each padded by ``pad_for_tp(., 16)`` as the dry-run pads
it), the shape cells and ``cell_applicable``, ``ARCH_IDS``,
``input_specs``, the roofline's analytic terms (``min_traffic_bytes``,
``model_flops_cell``) for every arch x cell, ``loopfix``'s units and
depth cuts, and the fusion planner (``plan``, ``model_fusion_report``,
``backend_prediction``) for every arch at three (batch, ctx, seq) points,
with JAX's two fusion assertions (``tests/test_coe_core.py``) on the
port. Also the roofline terms' H100 constants and the collective-bytes
sum of a trace's records."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import CONFIGS as JAX_CONFIGS
from repro.configs import SHAPE_CELLS as JAX_SHAPE_CELLS
from repro.configs import cell_applicable as jax_cell_applicable
from repro.configs import pad_for_tp as jax_pad_for_tp
from repro.core import fusion as jax_fusion
from repro.launch import loopfix as jax_loopfix
from repro.launch import roofline as jax_roofline
from repro.models import get_model as jax_get_model
from repro_torch.configs import (ARCH_IDS, CONFIGS, SHAPE_CELLS,
                                 cell_applicable, pad_for_tp)
from repro_torch.core import fusion
from repro_torch.launch import loopfix, roofline
from repro_torch.models import get_model

POINTS = ((8, 4096, 1), (8, 4096, 4096), (1, 32768, 1))


def _pairs(padded):
    for name, cfg in CONFIGS.items():
        jcfg = JAX_CONFIGS[name]
        if padded:
            cfg, jcfg = pad_for_tp(cfg, 16), jax_pad_for_tp(jcfg, 16)
        yield name, cfg, jcfg


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("padded", [False, True])
def test_config_predicates_and_param_counts(padded):
    for name, cfg, jcfg in _pairs(padded):
        for attr in ("kv_dim", "attention_free", "sub_quadratic",
                     "has_decode", "q_dim"):
            assert getattr(cfg, attr) == getattr(jcfg, attr), (name, attr)
        assert cfg.n_params() == jcfg.n_params(), name
        assert cfg.n_active_params() == jcfg.n_active_params(), name


def test_shape_cells_and_arch_ids():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert [dataclasses.astuple(c) for c in SHAPE_CELLS] == \
        [dataclasses.astuple(c) for c in JAX_SHAPE_CELLS]
    for padded in (False, True):
        for name, cfg, jcfg in _pairs(padded):
            for c, jc in zip(SHAPE_CELLS, JAX_SHAPE_CELLS):
                assert cell_applicable(cfg, c) == \
                    jax_cell_applicable(jcfg, jc), (name, c.name)


_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


def test_input_specs_match_jax():
    for name, cfg, jcfg in _pairs(True):
        for c, jc in zip(SHAPE_CELLS, JAX_SHAPE_CELLS):
            got = get_model(cfg).input_specs(c)
            want = jax_get_model(jcfg).input_specs(jc)
            assert sorted(got) == sorted(want), (name, c.name)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == tuple(want[k].shape), (name, k)
                assert v.dtype == _DTYPES[want[k].dtype.type], (name, k)


def test_roofline_cell_models_match_jax():
    for padded in (False, True):
        for name, cfg, jcfg in _pairs(padded):
            for c, jc in zip(SHAPE_CELLS, JAX_SHAPE_CELLS):
                assert roofline.min_traffic_bytes(cfg, c) == \
                    jax_roofline.min_traffic_bytes(jcfg, jc), (name, c.name)
                assert roofline.model_flops_cell(cfg, c) == \
                    jax_roofline.model_flops_cell(jcfg, jc), (name, c.name)


def test_loopfix_units_and_depth_cuts_match_jax():
    for name, cfg, jcfg in _pairs(True):
        assert loopfix.unit_counts(cfg) == jax_loopfix.unit_counts(jcfg), name
        for u in (1, 2):
            got = _fields(loopfix.reduced_depth_cfg(cfg, u))
            want = jax_loopfix.reduced_depth_cfg(jcfg, u)
            assert got == {k: getattr(want, k) for k in got}, (name, u)


def test_loopfix_extrapolation():
    c1 = {"flops": 10.0, "bytes": 7.0, "coll": 3.0}
    c2 = {"flops": 16.0, "bytes": 9.0, "coll": 3.0}
    out = loopfix.extrapolate(c1, c2, 5)
    assert (out["flops"], out["bytes"], out["coll"]) == (34.0, 15.0, 3.0)
    assert (out["flops_body"], out["flops_outside"]) == (6.0, 4.0)


def _report(r):
    return dataclasses.astuple(r) + (r.launch_ratio, r.traffic_ratio,
                                     r.intensity_unfused, r.intensity_fused)


def test_fusion_planner_matches_jax():
    assert [(k, list(m)) for k, m in fusion.FUSED_GROUPS] == \
        [(k, list(m)) for k, m in jax_fusion.FUSED_GROUPS]
    for name, cfg, jcfg in _pairs(False):
        for b, ctx, seq in POINTS:
            assert [dataclasses.astuple(o) for o in
                    fusion.decoder_layer_ops(cfg, b, ctx, seq)] == \
                [dataclasses.astuple(o) for o in
                 jax_fusion.decoder_layer_ops(jcfg, b, ctx, seq)], name
            assert _report(fusion.plan(cfg, b, ctx, seq)) == \
                _report(jax_fusion.plan(jcfg, b, ctx, seq)), name
            assert _report(fusion.model_fusion_report(cfg, b, ctx, seq)) == \
                _report(jax_fusion.model_fusion_report(jcfg, b, ctx, seq))
            for backend in ("fused", "xla"):
                assert fusion.backend_prediction(cfg, b, ctx, backend, seq) \
                    == jax_fusion.backend_prediction(jcfg, b, ctx, backend,
                                                     seq), (name, backend)


def test_fusion_paper_ranges_on_the_port():
    """JAX's two fusion assertions, on the port's planner."""
    cfg = CONFIGS["samba-coe-expert-7b"]
    dec = fusion.model_fusion_report(cfg, batch=8, ctx=4096, seq=1)
    assert 3.0 < dec.launch_ratio < 30.0
    assert dec.traffic_ratio >= 1.0
    pre = fusion.model_fusion_report(cfg, batch=8, ctx=4096, seq=4096)
    assert pre.intensity_fused > pre.intensity_unfused * 1.5
    r = fusion.plan(CONFIGS["mixtral-8x7b"], batch=8, ctx=4096, seq=4096)
    assert r.fused_hbm_bytes < r.unfused_hbm_bytes


def test_roofline_terms_use_the_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    t = roofline.RooflineTerms(
        arch="a", cell="c", mesh="m", chips=256, hlo_flops=989e12 * 256,
        hlo_bytes=3.35e12 * 256 * 2, collective_bytes=450e9 * 256 * 3,
        collective_breakdown={}, model_flops=989e12 * 128)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 3.0)
    assert t.bottleneck == "collective" and t.step_s == 3.0
    assert t.useful_flops_ratio == 0.5
    d = t.as_dict()
    assert d["roofline_fraction"] == pytest.approx(0.5 / 3.0)
    assert roofline.collective_bytes(
        [("all_gather_into_tensor", 8), ("wait_tensor", 8),
         ("all_reduce", 4), ("all_gather_into_tensor", 2),
         ("reduce_scatter_tensor", 1), ("all_to_all_single", 16)]) == \
        {"all-gather": 10, "all-reduce": 4, "reduce-scatter": 1,
         "all-to-all": 16}
