"""The port's architecture registry (``repro_torch.configs``) against the
reference's (``repro.configs``) on the CPU:

* ``list_archs()`` is the reference's ten ids, in its order, and each
  ``FULL`` and ``SMOKE`` equals the reference's in every field the port's
  ``ModelConfig`` has (it leaves out ``scan_unroll``, which only the
  reference's scan machinery reads; ``remat`` is the port's too);
* ``attention_mode="rm"`` is refused for the attention-free xlstm-350m,
  as the reference refuses it, and accepted everywhere else;
* the last four dense configs — olmo-1b (parameter-free layernorm),
  h2o-danube-3-4b (sliding window), qwen2-7b (QKV bias) and internvl2-1b
  (precomputed patch embeddings before the tokens) — give SMOKE logits
  within 1e-4 relative of the reference's, fp32 compute, in rm fused and
  exact mode, with the reference's weights carried across."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jget
from repro.configs import list_archs as jlist
from repro.models import transformer as jt
from repro_torch.configs import get_config, list_archs, supports_rm
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tt
from repro_torch.models.layers import apply_norm, init_norm

_jforward = jax.jit(jt.forward, static_argnums=1)

LOGITS_TOL = 1e-4   # relative: fp32 logits through 2 layers
DENSE = ["olmo-1b", "h2o-danube-3-4b", "qwen2-7b", "internvl2-1b"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def test_list_archs_is_the_reference_ten():
    assert list_archs() == jlist()
    assert len(list_archs()) == 10


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jlist())
def test_full_and_smoke_equal_reference(arch, smoke):
    ours = dataclasses.asdict(get_config(arch, smoke=smoke))
    theirs = dataclasses.asdict(jget(arch, smoke=smoke))
    assert set(theirs) - set(ours) == {"scan_unroll"}
    assert ours == {k: theirs[k] for k in ours}


@pytest.mark.parametrize("arch", jlist())
def test_rm_mode_refused_only_where_nothing_attends(arch):
    cfg = get_config(arch, smoke=True)
    if arch == "xlstm-350m":
        assert not supports_rm(cfg)
        with pytest.raises(ValueError, match="attention-free"):
            get_config(arch, attention_mode="rm")
        with pytest.raises(ValueError, match="attention-free"):
            jget(arch, attention_mode="rm")
        # its own mode and exact resolve
        assert get_config(arch, attention_mode="exact").attention_mode == \
            "exact"
    else:
        assert supports_rm(cfg)
        assert get_config(arch, smoke=True,
                          attention_mode="rm").attention_mode == "rm"


def test_nonparametric_ln_has_no_params():
    cfg = get_config("olmo-1b", smoke=True)
    assert init_norm(cfg, 8, torch.float32, "cpu") == {}
    x = torch.randn((2, 3, 8), generator=torch.Generator().manual_seed(0))
    got = apply_norm({}, cfg, x)
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    torch.testing.assert_close(got, (x - mean) / torch.sqrt(
        var + cfg.norm_eps), rtol=1e-6, atol=1e-6)
    params = tt.init_model(cfg, torch.Generator().manual_seed(0))
    assert params["final_norm"] == {}
    assert params["layers"][0]["norm1"] == {}


@pytest.mark.parametrize("field,value", [("mlp_kind", "geglu"),
                                         ("norm_kind", "batchnorm")])
def test_unknown_kinds_raise_the_references_error(field, value):
    """An unknown MLP or norm kind: ``ValueError`` in both packages, the
    port's message naming the kind."""
    import jax.numpy as jnp

    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    jcfg = dataclasses.replace(jget("qwen3-1.7b", smoke=True),
                               **{field: value})
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              **{field: value})
    if field == "mlp_kind":
        with pytest.raises(ValueError):
            jlayers.init_mlp(jcfg, jax.random.PRNGKey(0), 16, jnp.float32)
        with pytest.raises(ValueError, match=value):
            tlayers.init_mlp(cfg, torch.Generator().manual_seed(0), 16,
                             torch.float32)
    else:
        with pytest.raises(ValueError):
            jlayers.init_norm(jcfg, 16, jnp.float32)
        with pytest.raises(ValueError, match=value):
            init_norm(cfg, 16, torch.float32, "cpu")


def _batch(cfg, seed):
    """Tokens, and for the vision stub 6 precomputed patch embeddings put
    before them (numpy, for both packages)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 14))}
    if cfg.frontend == "vision_stub":
        batch["embeds"] = rng.standard_normal(
            (2, 6, cfg.d_model)).astype(np.float32) * 0.02
    return batch


@pytest.mark.parametrize("mode", ["rm", "exact"])
@pytest.mark.parametrize("arch", DENSE)
def test_smoke_logits_match_reference(arch, mode):
    jcfg = dataclasses.replace(jget(arch, smoke=True, attention_mode=mode),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, smoke=True,
                                          attention_mode=mode),
                               compute_dtype="float32")
    if mode == "rm":
        jcfg = dataclasses.replace(jcfg, rm=dataclasses.replace(
            jcfg.rm, fuse_featurize="on"))
    jp = jax.jit(jt.init_model, static_argnums=0)(jcfg,
                                                  jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    batch = _batch(jcfg, 3)
    want, _ = _jforward(jp, jcfg, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    with torch.no_grad():
        got, _ = tt.forward(tp, tcfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    t_all = 14 + (6 if "embeds" in batch else 0)
    assert tuple(got.shape) == (2, t_all, tcfg.vocab_size)
    assert torch.isfinite(got).all()
    assert _rel(got.numpy(), np.asarray(want)) <= LOGITS_TOL
