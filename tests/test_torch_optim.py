"""The port's optimizer, schedules, int8 quantization and tree utilities
(``repro_torch.optim``, ``repro_torch.common.tree``): the cases of
``tests/test_optim.py`` on the port, and the port against the reference
on the same inputs. AdamW holds the reference within 1e-6 (fp32 arithmetic
in the same order); the schedules and the quantizer are the reference's
fp32 expressions, within 1e-6 relative and bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as jtree
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedule as jsched
from repro_torch.common import tree as ttree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compressed_psum_with_feedback,
    dequantize_int8,
    global_norm,
    mask_frozen,
    quantize_int8,
    warmup_cosine,
    warmup_linear,
)
from repro_torch.train.steps import TrainHyper

ADAMW_TOL = 1e-6
# the reference's update under one jit (op by op it compiles every
# primitive of every leaf apart)
_jax_adamw = jax.jit(jadamw.adamw_update, static_argnums=(4,))


# -- the cases of tests/test_optim.py ---------------------------------------
def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor(2.0)}
    opt = adamw_init(params)
    cfg = AdamWConfig(weight_decay=0.0)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    for _ in range(300):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        g = dict(zip(live, torch.autograd.grad(loss(live), list(
            live.values()))))
        params, opt, _ = adamw_update(params, g, opt, 0.05, cfg)
    assert float(loss(params)) < 1e-3


def test_adamw_frozen_leaves_not_updated():
    params = {"attn": {"wq": torch.ones(4, 4), "rm_omegas": torch.ones(8, 4),
                       "rm_est": {"omegas": torch.ones(2, 3, 4)}}}
    opt = adamw_init(params)
    grads = ttree.tree_map_with_path(lambda _, p: torch.ones_like(p),
                                     params)
    new_params, _, _ = adamw_update(params, grads, opt, 0.1)
    assert not torch.allclose(new_params["attn"]["wq"], torch.ones(4, 4))
    assert torch.equal(new_params["attn"]["rm_omegas"], torch.ones(8, 4))
    assert torch.equal(new_params["attn"]["rm_est"]["omegas"],
                       torch.ones(2, 3, 4))
    masked = mask_frozen(grads)
    assert float(masked["attn"]["rm_est"]["omegas"].abs().sum()) == 0.0


def test_weight_decay_skips_1d():
    params = {"w": torch.ones(4, 4), "scale": torch.ones(4)}
    opt = adamw_init(params)
    zero_g = ttree.tree_map_with_path(lambda _, p: torch.zeros_like(p),
                                      params)
    new_params, _, _ = adamw_update(params, zero_g, opt, 0.1,
                                    AdamWConfig(weight_decay=0.5))
    assert float(new_params["w"][0, 0]) < 1.0          # decayed
    assert float(new_params["scale"][0]) == 1.0        # not decayed


def test_grad_clipping():
    grads = {"a": torch.full((10,), 100.0)}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    assert float(norm) > 100.0
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    grads = {"a": torch.full((10,), 1e-3)}               # small: untouched
    clipped, _ = clip_by_global_norm(grads, 1.0)
    np.testing.assert_allclose(clipped["a"].numpy(), 1e-3, rtol=1e-6)


def test_schedules_shape():
    for sched in (warmup_cosine, warmup_linear):
        lr0 = float(sched(0, 1e-3, 10, 100))
        lr_peak = float(sched(10, 1e-3, 10, 100))
        lr_end = float(sched(100, 1e-3, 10, 100))
        assert lr0 == 0.0 or lr0 < 1e-4
        assert abs(lr_peak - 1e-3) < 1e-4
        assert lr_end < lr_peak


# -- against the reference --------------------------------------------------
@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_linear"])
def test_schedules_match_reference(name):
    steps = np.arange(0, 130)
    want = np.asarray(getattr(jsched, name)(jnp.asarray(steps), 3e-4, 17,
                                            113))
    got = getattr(
        __import__("repro_torch.optim.schedule", fromlist=[name]), name)(
        torch.from_numpy(steps), 3e-4, 17, 113)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _as_dicts(tree):
    """The port's tree with each list as a dict keyed by index (the
    reference's tree walk takes dicts only), leaves as jnp arrays."""
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return {str(i): _as_dicts(v) for i, v in enumerate(tree)}
    return jnp.asarray(tree.numpy())


def _smoke_params_and_grads(seed):
    jcfg = jax_get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    tcfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    jp = jt.init_model(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(seed)
    grads = ttree.tree_map_with_path(
        lambda _, p: torch.from_numpy(np.asarray(
            rng.standard_normal(tuple(p.shape)) * 0.05, np.float32))
        if p.is_floating_point() else torch.zeros_like(p), tp)
    return tcfg, tp, grads


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_reference(clip):
    """Three AdamW steps on the qwen3 SMOKE params handed over from the
    reference, with the same gradients on both sides: params, moments and
    metrics within 1e-6 (clipped at 1.0, and not clipped at 1e3)."""
    _, tp, grads = _smoke_params_and_grads(0)
    cfg = AdamWConfig(grad_clip_norm=clip)
    jcfg = jadamw.AdamWConfig(grad_clip_norm=clip)
    jp, jg = _as_dicts(tp), _as_dicts(grads)
    jopt = jadamw.adamw_init(jp)
    params = ttree.tree_map_with_path(lambda _, p: p.clone(), tp)
    opt = adamw_init(params)
    for lr in (1e-3, 2e-3, 5e-4):
        jp, jopt, jm = _jax_adamw(jp, jg, jopt, jnp.float32(lr), jcfg)
        params, opt, m = adamw_update(params, grads, opt, lr, cfg)
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            ADAMW_TOL * float(jm["grad_norm"])
    assert int(opt["step"]) == int(jopt["step"]) == 3
    for got, want in ((params, jp), (opt["mu"], jopt["mu"]),
                      (opt["nu"], jopt["nu"])):
        flat_w = jtree.flatten_dict(want)
        for key, leaf in ttree.flatten_dict(got).items():
            np.testing.assert_allclose(leaf.numpy(), np.asarray(flat_w[key]),
                                       atol=ADAMW_TOL, rtol=0, err_msg=key)


def test_reference_decays_its_stacked_1d_leaves():
    """A recorded difference, not a tolerance: the reference stacks its
    layers on a leading axis, so a layer's norm scale ``[G, d]`` has ndim 2
    and takes weight decay there, against its own rule that 1-D params
    skip it. The port keeps one dict a layer and skips decay on every 1-D
    leaf. With zero gradients the two differ on those leaves by
    ``lr * weight_decay * p`` (within 1e-6 relative), and nowhere else."""
    jcfg = jax_get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    tcfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    jp = jt.init_model(jcfg, jax.random.PRNGKey(0))
    jg = jax.tree_util.tree_map(jnp.zeros_like, jp)
    want, _, _ = _jax_adamw(jp, jg, jadamw.adamw_init(jp),
                            jnp.float32(1e-2), jadamw.AdamWConfig())
    want = ttree.flatten_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, want), tcfg))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    old = {k: v.clone() for k, v in ttree.flatten_dict(tp).items()}
    got, _, _ = adamw_update(tp, ttree.tree_map_with_path(
        lambda _, p: torch.zeros_like(p), tp), adamw_init(tp), 1e-2)
    stacked_1d = []
    for key, leaf in ttree.flatten_dict(got).items():
        if key.startswith("layers/") and leaf.ndim == 1:
            stacked_1d.append(key)
            np.testing.assert_allclose(
                want[key], (old[key] * (1 - 1e-2 * 0.1)).numpy(), rtol=1e-6)
            assert torch.equal(leaf, old[key])
        else:   # the reference's jit rounds p - lr * (u + wd p) once less
            np.testing.assert_allclose(leaf.numpy(), want[key], rtol=1e-6,
                                       atol=0, err_msg=key)
    assert any(k.endswith("norm1/scale") for k in stacked_1d)


def test_global_norm_and_clip_match_reference():
    _, tp, grads = _smoke_params_and_grads(3)
    jg = _as_dicts(grads)
    assert abs(float(global_norm(grads)) - float(jadamw.global_norm(jg))) \
        <= 1e-6 * float(jadamw.global_norm(jg))
    got, _ = clip_by_global_norm(grads, 0.5)
    want, _ = jadamw.clip_by_global_norm(jg, 0.5)
    flat_w = jtree.flatten_dict(want)
    for key, leaf in ttree.flatten_dict(got).items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(flat_w[key]),
                                   atol=1e-7, rtol=1e-6)


def test_int8_quantization_matches_reference():
    x = np.random.default_rng(0).standard_normal((37, 11)).astype(np.float32)
    q, scale = quantize_int8(torch.from_numpy(x))
    jq, jscale = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(dequantize_int8(q, scale).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq,
                                                                   jscale)))


def test_pod_compression_waits_for_meshes():
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        compressed_psum_with_feedback({}, {}, axis_name="pod")
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        TrainHyper(grad_compression="int8_pod")
    with pytest.raises(ValueError, match="grad_compression"):
        TrainHyper(grad_compression="fp8")


# -- tree utilities ---------------------------------------------------------
def test_tree_size_and_bytes_match_reference():
    jcfg = jax_get_config("hubert-xlarge", smoke=True, attention_mode="rm")
    tcfg = get_config("hubert-xlarge", smoke=True, attention_mode="rm")
    jp = jt.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    assert ttree.tree_size(tp) == jtree.tree_size(jp)
    assert ttree.tree_bytes(tp) == jtree.tree_bytes(jp)


def test_flatten_unflatten_is_a_bijection():
    tree = {"a": {"b": torch.ones(2), "empty": {}},
            "layers": [{"w": torch.zeros(3)}, {"w": torch.ones(3)}],
            "step": torch.tensor(4)}
    flat = ttree.flatten_dict(tree)
    assert "layers/1/w" in flat and "a/empty/__empty_dict__" in flat
    back = ttree.unflatten_dict(flat)
    assert back["a"]["empty"] == {}
    assert isinstance(back["layers"], list) and len(back["layers"]) == 2
    assert torch.equal(back["layers"][1]["w"], torch.ones(3))
    assert set(ttree.flatten_dict(back)) == set(flat)
    paths = []
    ttree.tree_map_with_path(lambda p, _: paths.append(p), tree)
    assert ("layers", 1, "w") in paths
    # the reference's flattening of the same dict-only part agrees
    dict_only = {"a": {"b": np.ones(2), "empty": {}}}
    assert set(jtree.flatten_dict(dict_only)) == set(
        ttree.flatten_dict({"a": {"b": torch.ones(2), "empty": {}}}))


def test_adamw_state_has_params_layout():
    _, tp, _ = _smoke_params_and_grads(1)
    opt = adamw_init(tp)
    assert set(ttree.flatten_dict(opt["mu"])) == set(
        ttree.flatten_dict(tp))
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0
    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(
        jadamw.AdamWConfig())
