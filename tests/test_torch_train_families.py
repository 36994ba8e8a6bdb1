"""One train step of each remaining family, the port against the JAX
package on the CPU: reduced configs in f32 (weights from JAX's init through
numpy), one batch from ``SyntheticLM``, remat on, the same AdamW config.
The expert (dense) and Mixtral (moe) are held over three steps, with
accumulation, in ``test_torch_train.py``.

Tolerances, as there: the loss and the gradient norm within 1e-5
relative; each leaf's update within a relative L2 error of 1e-3 (a gradient
entry within f32 noise of 0 can take either sign in AdamW's first step;
the f32 families read at most 8.0e-4, DeepSeek's ``w_dkv``). Two kinds of
leaf are held otherwise:
  * a key bias (``attn/bk``): its gradient is 0 in exact arithmetic on
    every element RoPE does not rotate (it shifts a row's scores alike), so
    its first update is the sign of rounding noise in each framework
    (chatglm3-6b's reads 1 %). Both updates are held to AdamW's bound, lr
    a param (the bias starts at 0).
  * xLSTM and Whisper round to bf16 inside, as JAX's do (xLSTM's products;
    Whisper's encoder runs on bf16 weights only, JAX's scan refusing an f32
    carry, so its encoder layers stay bf16 here): the loss and the gradient
    norm within 1e-3 relative (read 1.3e-6 / 1.7e-4 and 2.0e-5 / 4.4e-5);
    their updates are not compared, bf16 noise flipping AdamW's signs
    (13 % and 17 % of a leaf's update)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.distributed import stepfn as jax_stepfn
from repro.launch.mesh import make_mesh
from repro.models import get_model as jax_get_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.bridge import to_numpy, to_torch
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed import stepfn
from repro_torch.optim import AdamWConfig

UPDATE_REL_L2 = 1e-3
STEP_REL = 1e-5
OPT = dict(warmup_steps=2, decay_steps=4)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", [
    "deepseek-v2-lite-16b", "recurrentgemma-9b", "whisper-small",
    "xlstm-1.3b", "granite-8b", "chatglm3-6b", "starcoder2-3b",
    "qwen2-vl-2b", "qwen2.5-32b"])
def test_one_train_step_matches_jax(arch):
    _step_against_jax(arch, jax_reduced(jax_get_config(arch)),
                      reduced(get_config(arch)))


# the fields ``reduced(..., full_heads=True)`` keeps from the full config
FULL_HEADS = ("n_heads", "n_kv_heads", "head_dim", "qk_nope_dim",
              "qk_rope_dim", "v_head_dim", "mrope_sections")


@pytest.mark.parametrize("arch", [
    "recurrentgemma-9b", "deepseek-v2-lite-16b", "whisper-small"])
def test_full_heads_step_matches_jax(arch):
    """``reduced(..., full_heads=True)`` (what ``launch/train.py --reduced``
    trains) against JAX's reduced config given the same heads, one step as
    above; the port's forward calls ``layers.attention`` and ``lru_scan``
    as often as ``stepfn.kernel_launches`` counts their LSE forms and
    ``lru_scan`` launches on the card (remat: each twice)."""
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.models import layers as L
    cfg = reduced(get_config(arch), full_heads=True)
    full = get_config(arch)
    assert all(getattr(cfg, f) == getattr(full, f) for f in FULL_HEADS)
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)),
                               **{f: getattr(cfg, f) for f in FULL_HEADS})
    calls = {"flash_prefill[lse]": 0, "lru_scan": 0}
    real = L.attention, lru_ops.lru_scan

    def counted(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call
    L.attention = counted("flash_prefill[lse]", real[0])
    lru_ops.lru_scan = counted("lru_scan", real[1])
    try:
        _step_against_jax(arch, jcfg, cfg)
    finally:
        L.attention, lru_ops.lru_scan = real
    want = stepfn.kernel_launches(cfg)
    assert calls == {k: want[k] for k in calls}, (calls, want)


def _step_against_jax(arch, jcfg, cfg):
    init = jax_get_model(jcfg).init(jax.random.PRNGKey(4))
    params = {k: jax.tree.map(np.asarray if k == "enc_layers" else
                              (lambda x: np.asarray(x, np.float32)), v)
              for k, v in init.items()}
    S = 64 if cfg.family == "xlstm" else 32
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=2, seed=6)).batch_at(0)
    if cfg.family == "encdec":
        frames = np.random.RandomState(7).standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        batch["enc_embeds"] = frames
    mesh = make_mesh((1, 1), ("data", "model"))
    with mesh:
        fn, sh, _ = jax_stepfn.make_train_step(jcfg, mesh,
                                               JaxAdamWConfig(**OPT))
        jp = jax.tree.map(jnp.asarray, params)
        js, jm = fn(jax.device_put(
            {"params": jp, "opt": jax_init_opt_state(jp)}, sh),
            jax.tree.map(jnp.asarray, batch))
        want = jax.tree.map(np.asarray, js["params"])
    step = stepfn.make_train_step(cfg, AdamWConfig(**OPT))
    ts, tm = step(stepfn.init_train_state(to_torch(params)),
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    got = to_numpy(ts["params"])
    bf16_inside = cfg.family in ("xlstm", "encdec")
    for key in ("loss", "grad_norm"):
        g, w = float(tm[key]), float(jm[key])
        tol = 1e-3 if bf16_inside else STEP_REL
        assert abs(g - w) <= tol * abs(w), (arch, key, g, w)
    if bf16_inside:
        return
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_p = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    lr = float(tm["lr"])
    for path, a in jax.tree_util.tree_flatten_with_path(got)[0]:
        name = jax.tree_util.keystr(path)
        ug = a.astype(np.float64) - flat_p[path]
        uw = flat_w[path].astype(np.float64) - flat_p[path]
        if name.endswith("['attn']['bk']"):
            assert max(np.abs(ug).max(), np.abs(uw).max()) <= lr * 1.0001
            continue
        err = np.linalg.norm(ug - uw) / max(np.linalg.norm(uw), 1e-30)
        assert err <= UPDATE_REL_L2, (arch, name, err)
