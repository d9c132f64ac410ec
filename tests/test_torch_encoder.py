"""The port's hubert encoder against the reference, at the SMOKE config with
attention_mode="rm" and the reference's weights carried across by
``repro_torch.convert.params_from_jax``: the first layer's attention output
(an attention error of ~1% moves the SMOKE logits by far less than a
logits tolerance can see, so the attention output is held directly), the
logits, and the step functions of ``train.steps``; on the fused path (B3 +
B4; ``fuse_featurize="on"`` on the reference side, which reaches its jnp
oracle on the CPU), the two-launch path (``"off"``: featurize, then the
non-causal einsums) and the tensor_sketch family. Tolerances, relative to
max(1, max |reference|): attention 1e-5 and logits 1e-4 at fp32 compute,
logits 3e-2 at bf16 compute (activations round at different places in the
two frameworks)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt
from repro_torch.train import init_params, make_eval_step, make_prefill_step

BF16_LOGIT_TOL = 3e-2
# (estimator, fuse_featurize): the fused path, the two-launch path, and
# the tensor_sketch, ctr and structured families (two-launch on their own)
PATHS = [("rm", "on"), ("rm", "off"), ("tensor_sketch", "auto"),
         ("ctr", "auto"), ("structured", "auto")]
PATH_IDS = ["rm-fused", "rm-two-launch", "tensor_sketch", "ctr",
            "structured"]


def _configs(est="rm", fuse="on", compute_dtype="float32"):
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("hubert-xlarge", smoke=True, attention_mode="rm",
                  estimator=est)
        out.append(dataclasses.replace(
            cfg, compute_dtype=compute_dtype,
            rm=dataclasses.replace(cfg.rm, fuse_featurize=fuse)))
    return out


def _models(est="rm", fuse="on", compute_dtype="float32", seed=0):
    jcfg, tcfg = _configs(est, fuse, compute_dtype)
    jp = jt.init_model(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def _embeds(b, t, d, seed):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(
        np.float32)


def _rel(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _first_attention_reference(jp, jcfg, batch):
    jp = jt.cast_params_to_compute(jp, jcfg)
    x, positions = jt._prepare_inputs(jp, jcfg, batch)
    layer = jax.tree_util.tree_map(lambda a: a[0],
                                   jp["groups"]["b0_attn_mlp"])
    h = jlayers.apply_norm(layer["norm1"], jcfg, x)
    return jattn.attention_forward(layer["attn"], jcfg, h, positions)


def _first_attention_port(tp, tcfg, batch):
    cp = tt.cast_params_to_compute(tp, tcfg)
    x, positions = tt._prepare_inputs(cp, tcfg, batch)
    layer = cp["layers"][0]
    h = tlayers.apply_norm(layer["norm1"], tcfg, x)
    with torch.no_grad():
        return tattn.attention_forward(layer["attn"], tcfg, h, positions)


def test_params_cross_with_layernorm_and_mlp_biases():
    """The layernorm bias and the GELU MLP's ``b_up``/``b_down`` cross
    with the rest, one dict per layer (nonzero values, so a dropped or
    swapped leaf shows)."""
    jcfg, jp, tcfg, _ = _models()
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(a.dtype)
        if a.dtype == np.float32 else np.asarray(a), jp)
    tp = params_from_jax(jp, tcfg)
    group = jp["groups"]["b0_attn_mlp"]
    for i, layer in enumerate(tp["layers"]):
        for part, name in (("norm1", "bias"), ("norm2", "scale"),
                           ("mlp", "b_up"), ("mlp", "b_down"),
                           ("mlp", "w_up")):
            np.testing.assert_array_equal(layer[part][name].numpy(),
                                          group[part][name][i])
        assert set(layer["mlp"]) == {"w_up", "b_up", "w_down", "b_down"}
    np.testing.assert_array_equal(tp["final_norm"]["bias"].numpy(),
                                  jp["final_norm"]["bias"])
    np.testing.assert_array_equal(tp["embed"]["unembed"].numpy(),
                                  jp["embed"]["unembed"])


def test_init_model_builds_the_encoder_layout():
    _, tcfg = _configs()
    params = tt.init_model(tcfg, torch.Generator().manual_seed(0))
    jcfg, jp, _, _ = _models()
    layer = params["layers"][0]
    group = jp["groups"]["b0_attn_mlp"]
    for part in ("norm1", "norm2", "mlp", "attn"):
        assert set(layer[part]) == set(group[part]), part
        for name, leaf in layer[part].items():
            if torch.is_tensor(leaf):
                assert tuple(leaf.shape) == group[part][name].shape[1:]
    assert set(params["final_norm"]) == {"scale", "bias"}
    assert params["embed"]["unembed"].shape == (tcfg.d_model,
                                                tcfg.vocab_size)


@pytest.mark.parametrize("est,fuse", PATHS, ids=PATH_IDS)
def test_first_layer_attention_matches_reference(est, fuse):
    jcfg, jp, tcfg, tp = _models(est, fuse, seed=1)
    emb = _embeds(2, 37, tcfg.d_model, 1)
    want = _first_attention_reference(jp, jcfg,
                                      {"embeds": jnp.asarray(emb)})
    got = _first_attention_port(tp, tcfg, {"embeds": torch.from_numpy(emb)})
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("est,fuse", PATHS, ids=PATH_IDS)
def test_logits_match_reference(est, fuse):
    jcfg, jp, tcfg, tp = _models(est, fuse, seed=2)
    emb = _embeds(2, 40, tcfg.d_model, 2)
    want, _ = jt.forward(jp, jcfg, {"embeds": jnp.asarray(emb)})
    with torch.no_grad():
        got, aux = tt.forward(tp, tcfg, {"embeds": torch.from_numpy(emb)})
    assert got.dtype == torch.float32 and aux == {}
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("est,fuse", PATHS[:2], ids=PATH_IDS[:2])
def test_bf16_logits_within_budget(est, fuse):
    """Default bf16 compute (embeds cast to bf16 before the position
    table is added) with the fp32 RM precision."""
    jcfg, jp, tcfg, tp = _models(est, fuse, "bfloat16", seed=3)
    emb = _embeds(2, 40, tcfg.d_model, 3)
    want, _ = jt.forward(jp, jcfg, {"embeds": jnp.asarray(emb)})
    with torch.no_grad():
        got, _ = tt.forward(tp, tcfg, {"embeds": torch.from_numpy(emb)})
    assert _rel(got, want) <= BF16_LOGIT_TOL


def test_embeds_and_tokens_concatenate_as_the_reference():
    """The input path of a batch holding both: embeds first, then the
    embedded tokens, the sinusoidal table over the whole length."""
    jcfg, jp, tcfg, tp = _models(seed=4)
    emb = _embeds(2, 10, tcfg.d_model, 4)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 7))
    want, _ = jt.forward(jp, jcfg, {"embeds": jnp.asarray(emb),
                                    "tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        got, _ = tt.forward(tp, tcfg, {"embeds": torch.from_numpy(emb),
                                       "tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 17, tcfg.vocab_size)
    assert _rel(got, want) <= 1e-4
    with pytest.raises(ValueError, match="'embeds'"):
        tt.forward(tp, tcfg, {"targets": torch.zeros(2, 3)})


@pytest.mark.parametrize("est,fuse", PATHS, ids=PATH_IDS)
def test_prefill_and_eval_steps_match_reference(est, fuse):
    """``make_prefill_step`` (an encode: logits, no cache) and
    ``make_eval_step`` (framewise CE + z-loss, ignore index -1) against
    the reference's ``train/steps.py``, metric by metric."""
    jcfg, jp, tcfg, tp = _models(est, fuse, seed=5)
    emb = _embeds(2, 33, tcfg.d_model, 6)
    targets = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 33))
    targets[1, 25:] = -1
    jbatch = {"embeds": jnp.asarray(emb),
              "targets": jnp.asarray(targets, jnp.int32)}
    tbatch = {"embeds": torch.from_numpy(emb),
              "targets": torch.from_numpy(targets)}
    want_logits, want_cache = jsteps.make_prefill_step(jcfg, 64)(jp, jbatch)
    got_logits, got_cache = make_prefill_step(tcfg, 64)(tp, tbatch)
    assert want_cache is None and got_cache is None
    assert _rel(got_logits, want_logits) <= 1e-4
    want = jsteps.make_eval_step(jcfg)(jp, jbatch)
    got = make_eval_step(tcfg)(tp, tbatch)
    assert set(got) == set(want) == {"ce", "z_loss", "tokens", "loss"}
    for name in want:
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=1e-5, err_msg=name)
    assert got["tokens"].item() == 2 * 33 - 8
    assert abs(got["ce"].item() - math.log(tcfg.vocab_size)) < 0.5


def test_layer_helpers_match_reference_exactly():
    """layernorm, the tanh GELU and the sinusoidal table within 1e-6 of
    the reference's ``layers.py``; the exact-erf GELU would miss by ~5e-4."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(8)
    x = (3.0 * rng.normal(size=(2, 5, tcfg.d_model)) + 1.0).astype(
        np.float32)
    norm = {"scale": rng.normal(size=tcfg.d_model).astype(np.float32),
            "bias": rng.normal(size=tcfg.d_model).astype(np.float32)}
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in norm.items()},
                              jcfg, jnp.asarray(x))
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in
                              norm.items()}, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    u = (4.0 * rng.normal(size=(64, 32))).astype(np.float32)
    gelu = torch.nn.functional.gelu(torch.from_numpy(u), approximate="tanh")
    np.testing.assert_allclose(gelu.numpy(), np.asarray(jax.nn.gelu(
        jnp.asarray(u))), atol=1e-6, rtol=0)
    mlp = {"w_up": rng.normal(size=(tcfg.d_model, tcfg.d_ff)) * 0.1,
           "b_up": rng.normal(size=tcfg.d_ff),
           "w_down": rng.normal(size=(tcfg.d_ff, tcfg.d_model)) * 0.1,
           "b_down": rng.normal(size=tcfg.d_model)}
    mlp = {k: v.astype(np.float32) for k, v in mlp.items()}
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in mlp.items()},
                             jcfg, jnp.asarray(x[0] * 0.1))
    got = tlayers.apply_mlp({k: torch.from_numpy(v) for k, v in mlp.items()},
                            tcfg, torch.from_numpy(x[0] * 0.1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for dim, t in ((64, 256), (1280, 1500), (80, 40)):
        pos = np.tile(np.arange(t, dtype=np.int32), (2, 1))
        want = jlayers.sinusoidal_positions(jnp.asarray(pos), dim)
        got = tlayers.sinusoidal_positions(torch.from_numpy(pos), dim)
        assert got.dtype == torch.float32 and got.shape == (2, t, dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


def test_hubert_config_resolves_as_the_reference():
    for smoke in (False, True):
        want = jax_get_config("hubert-xlarge", smoke=smoke,
                              attention_mode="rm")
        got = get_config("hubert-xlarge", smoke=smoke, attention_mode="rm")
        for field in dataclasses.fields(got):
            g, w = getattr(got, field.name), getattr(want, field.name)
            if dataclasses.is_dataclass(g):      # the rm sub-config
                g, w = dataclasses.asdict(g), dataclasses.asdict(w)
            assert g == w, field.name
    full = get_config("hubert-xlarge", attention_mode="rm")
    assert (full.num_layers, full.d_model, full.num_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size) == (
        48, 1280, 16, 80, 5120, 504)
    assert not full.causal and full.frontend == "audio_stub"
    dataclasses.replace(full, frontend="vision_stub").validate()
    with pytest.raises(ValueError, match="frontend"):
        dataclasses.replace(full, frontend="video_stub").validate()


def test_encoder_refuses_decode_prefill_cache_and_serving():
    """An encoder has a forward only: the decode cache, the attention
    prefill-cache path, the model prefill and the serving engine refuse it
    as "encoder-only"."""
    from repro_torch.launch.serve import make_engine

    _, tcfg = _configs()
    params = tt.init_model(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="encoder-only"):
        tt.init_decode_cache(tcfg, 2, 64, "cpu")
    cp = tt.cast_params_to_compute(params, tcfg)
    x = torch.zeros(1, 4, tcfg.d_model)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="encoder-only"):
        tattn.attention_prefill_cache(cp["layers"][0]["attn"], tcfg, x, pos)
    with pytest.raises(ValueError, match="encoder-only"):
        tattn.init_attention_cache(tcfg, 2, "cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        tt.prefill(params, tcfg, {"embeds": torch.zeros(1, 4,
                                                        tcfg.d_model)}, 16)
    with pytest.raises(ValueError, match="encoder-only"):
        make_engine("hubert-xlarge", device="cpu")


def test_init_params_targets_cuda_and_runs_on_cpu_when_asked():
    import inspect

    assert inspect.signature(init_params).parameters["device"].default \
        == "cuda"
    _, tcfg = _configs()
    params = init_params(tcfg, seed=0, device="cpu")
    assert params["layers"][0]["mlp"]["b_up"].device.type == "cpu"
    logits, cache = make_prefill_step(tcfg, tcfg.max_seq_len)(
        params, {"embeds": torch.zeros(1, 9, tcfg.d_model)})
    assert cache is None and logits.shape == (1, 9, tcfg.vocab_size)
    assert torch.isfinite(logits).all()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(tcfg)


@pytest.mark.parametrize("est,fuse", [("rm", "on"), ("rm", "off"),
                                      ("tensor_sketch", "auto")],
                         ids=["rm-fused", "rm-two-launch", "tensor_sketch"])
def test_compute_params_hold_the_slab_once(est, fuse):
    """The fused rm encoder's compute params carry the slab of kernels B3
    and B4 (``rm_slab``: the packed omegas ``rm_w`` laid out by
    ``pack_noncausal``), made once per weight set: a second cast keeps the
    same slab, and the forward on the cast params equals the forward on
    the master weights. The other paths get no slab."""
    from repro_torch.kernels.rm_attention.noncausal import (
        featurize_slab_ref,
        pack_noncausal,
    )
    from repro_torch.kernels.rm_feature.ref import rm_feature_fused_ref

    _, tcfg = _configs(est, fuse)
    params = tt.init_model(tcfg, torch.Generator().manual_seed(0))
    cp = tt.cast_params_to_compute(params, tcfg)
    attn = cp["layers"][0]["attn"]
    again = tt.cast_params_to_compute(cp, tcfg)["layers"][0]["attn"]
    assert again.get("rm_slab") is attn.get("rm_slab")
    if (est, fuse) != ("rm", "on"):
        assert "rm_slab" not in attn
        return
    plan = tattn.rm_plan_for(tcfg, tcfg.resolved_head_dim)
    want = pack_noncausal(attn["rm_w"], plan.column_degrees(),
                          plan.column_scales())
    assert torch.equal(attn["rm_slab"].slab, want.slab)
    assert attn["rm_slab"].tile_rows == want.tile_rows
    x = torch.randn(5, tcfg.resolved_head_dim,
                    generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(
        featurize_slab_ref(x, attn["rm_slab"]).numpy(),
        rm_feature_fused_ref(x, attn["rm_w"],
                             *map(torch.from_numpy,
                                  (plan.column_degrees(),
                                   plan.column_scales()))).numpy(),
        atol=1e-6, rtol=0)
    batch = {"embeds": torch.from_numpy(_embeds(1, 7, tcfg.d_model, 3))}
    with torch.inference_mode():
        a, _ = tt.forward(params, tcfg, batch)
        b, _ = tt.forward(cp, tcfg, batch)
    assert torch.equal(a, b)
