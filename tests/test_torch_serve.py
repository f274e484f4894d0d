"""The port's arch registry, its accounting and its serving entry points,
against the JAX reference where it has them, on the CPU.

* ``ARCH_IDS`` is the reference's; every arch's config and smoke config
  equal the reference's field by field (the MoE, MLA and SSM sub-configs
  too); the five archs that raised "not yet ported" until their parts
  were ported (musicgen-large and llava-next-34b: the audio and VLM
  modalities; deepseek-v2-lite-16b, deepseek-v2-236b and
  jamba-1.5-large-398b: MoE, MLA and Mamba) construct.
* ``total_param_count``, ``active_param_count`` and ``model_flops`` at
  full width equal the reference's (arithmetic on ParamDefs: nothing is
  allocated).
* ``launch/serve.main`` and ``examples/serve_decode.main`` run at the
  smoke size; the example's greedy tokens equal the reference's greedy
  decode from the same params, token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.common import paramdef as r_pd
from repro.models import model as r_model
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.models import model as t_model

# archs that raised "not yet ported" until their parts were ported: the
# audio and VLM modalities, then MoE, MLA and Mamba
NOW_PORTED = ["musicgen-large", "llava-next-34b", "deepseek-v2-lite-16b",
              "deepseek-v2-236b", "jamba-1.5-large-398b"]
PORTED = ["xlstm-1.3b", "granite-3-8b", "h2o-danube-3-4b", "qwen1.5-4b",
          "qwen3-1.7b"] + NOW_PORTED


def test_arch_ids_are_the_reference_s():
    assert t_configs.ARCH_IDS == r_configs.ARCH_IDS
    assert sorted(PORTED) == sorted(r_configs.ARCH_IDS)


def _fields(cfg, names):
    out = {n: getattr(cfg, n) for n in names}
    for k in ("xlstm", "moe", "mla", "ssm"):
        if out.get(k) is not None:
            out[k] = dataclasses.asdict(out[k])
    return out


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_reference_field_by_field(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    r_cfg = getattr(r_configs, get)(arch)
    t_cfg = getattr(t_configs, get)(arch)
    names = ({f.name for f in dataclasses.fields(r_cfg)}
             & {f.name for f in dataclasses.fields(t_cfg)})
    assert {"qk_norm", "qkv_bias", "window", "tie_embeddings",
            "rope_theta", "pattern"} <= names
    assert _fields(t_cfg, names) == _fields(r_cfg, names)


@pytest.mark.parametrize("arch", NOW_PORTED)
def test_unported_archs_raise(arch):
    """No arch raises any more: each of those that did constructs, full
    and smoke."""
    for get in (t_configs.get_config, t_configs.get_smoke_config):
        assert get(arch).name.startswith(arch)


@pytest.mark.parametrize("arch", PORTED)
def test_param_counts_and_flops_equal_reference(arch):
    r_cfg, t_cfg = r_configs.get_config(arch), t_configs.get_config(arch)
    assert t_model.total_param_count(t_cfg) == \
        r_model.total_param_count(r_cfg)
    assert t_model.active_param_count(t_cfg) == \
        r_model.active_param_count(r_cfg)
    assert t_model.model_flops(t_cfg, 4096) == \
        r_model.model_flops(r_cfg, 4096)
    if arch == "qwen3-1.7b":
        # tie_embeddings is recorded, not applied, in both packages
        assert t_model.total_param_count(t_cfg) == 2_031_739_904
    if arch == "musicgen-large":      # no token embedding, 4 heads
        assert t_model.total_param_count(t_cfg) == 2_432_894_976
    if arch == "llava-next-34b":
        assert t_model.total_param_count(t_cfg) == 34_388_917_248


def test_serve_main_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(
        ["--arch", "qwen3-1.7b", "--batch", "2", "--prompt-len", "5",
         "--gen", "4"], device="cpu")
    assert out["tokens"].shape == (2, 4)
    assert out["decode_steps"] == 3 and out["prefill_s"] > 0
    assert int(out["tokens"].max()) < 512 and out["peak_bytes"] is None
    printed = capsys.readouterr().out
    assert "prefill 5 tokens x 2" in printed and "tok/s" in printed


def test_serve_decode_example_runs_and_is_greedy_decode():
    """``serve_decode.main`` on the CPU; then its ``generate`` from the
    reference's params equals the reference's greedy decode token for
    token, and its step logits the reference's at 1e-4."""
    from repro_torch.examples import serve_decode
    out = serve_decode.main(device="cpu")
    assert set(out) == set(serve_decode.ARCHS)
    assert all(g.shape == (serve_decode.B, serve_decode.GEN)
               for g in out.values())
    arch, B, P, G = "h2o-danube-3-4b", 2, 6, 4
    r_cfg = r_configs.get_smoke_config(arch)
    params = jax.device_get(r_pd.init_params(jax.random.PRNGKey(0),
                                             r_model.model_defs(r_cfg)))
    toks = np.random.default_rng(0).integers(
        0, r_cfg.vocab_size, (B, P)).astype(np.int32)
    logits, caches = r_model.prefill(params, r_cfg, {"tokens": toks})
    target = r_pd.shape_tree(r_model.cache_defs(r_cfg, B, P + G))
    caches = jax.tree.map(
        lambda c, t: c if c.shape == t.shape else jnp.pad(
            c, [(0, ts - cs) for cs, ts in zip(c.shape, t.shape)]),
        caches, target)
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    want, steps = [tok], []
    for i in range(G - 1):
        lg, caches = r_model.decode_step(params, r_cfg, {"tokens": tok},
                                         caches, jnp.asarray(P + i))
        tok = jnp.argmax(lg[:, 0], -1)[:, None]
        want.append(tok)
        steps.append(lg)
    t_cfg = t_configs.get_smoke_config(arch)
    got, t_steps = serve_decode.generate(
        t_cfg, bridge.from_reference(params, "cpu"), torch.from_numpy(toks),
        G)
    assert np.array_equal(got.numpy(), np.concatenate(want, axis=1))
    want_steps = np.concatenate(steps, axis=1)
    err = np.abs(t_steps.numpy() - want_steps).max() / np.abs(
        want_steps).max()
    assert err <= 1e-4, err
