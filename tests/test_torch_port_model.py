"""The port's policy modules against the JAX package's, on the CPU in fp32.

Each JAX module gets a flax param tree with the shapes of its ``init``
(traced, not run) and seeded numpy values; the port's converter carries the
same tree into the torch module, and both run on the same inputs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port_common import (
    SMALL_OVERRIDES, build_both, install_gumbel_rsample, jax_batch, make_draws, make_raw_batch,
    random_flax_params, shift_draws, small_config, torch_raw,
)
from hulc2_torch.configs.flagship import FLAGSHIP_OVERRIDES, flagship_config
from hulc2_torch.data.device_transforms import make_batch_transform
from hulc2_torch.models import clip_text, decoders, plan_nets, vision
from hulc2_torch.models.build import build_policy
from hulc2_torch.utils import convert

# fp32 on both sides; convolutions, matmuls and reductions sum in other orders
ATOL = 2e-5


def _flax_params(module, *args, seed=0):
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)
    return random_flax_params(shapes, seed)


def _load(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def _frames(hw, n=3, seed=0):
    return np.random.default_rng(seed).standard_normal((n, hw, hw, 3)).astype(np.float32)


def test_vision_network_matches_jax():
    from hulc2_tpu.models.vision import VisionNetwork as JVision

    x = _frames(96)
    jmod = JVision(visual_features=64)
    params = _flax_params(jmod, jnp.asarray(x))
    want = jmod.apply(params, jnp.asarray(x))
    tmod = _load(vision.VisionNetwork(64), convert.vision_network(params["params"]))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_vision_network_gripper_matches_jax():
    """Covers the space-to-depth stem unpacking and the NCHW flatten before the FC."""
    from hulc2_tpu.models.vision import VisionNetworkGripper as JGripper

    x = _frames(64, seed=1)
    jmod = JGripper(visual_features=64)
    params = _flax_params(jmod, jnp.asarray(x))
    assert params["params"]["trunk"]["conv0"]["conv"]["kernel"].shape == (2, 2, 48, 32)
    want = jmod.apply(params, jnp.asarray(x))
    tmod = _load(vision.VisionNetworkGripper(64, 64), convert.vision_network_gripper(params["params"]))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_clip_text_transformer_matches_jax():
    from hulc2_tpu.models.clip_text import ClipTextTransformer as JClip

    cfg = small_config()
    raw = make_raw_batch(np.random.default_rng(2), cfg)
    tokens = raw["lang"]["lang"]
    kw = dict(width=32, heads=2, layers=2, output_dim=24, frozen=False)
    jmod = JClip(**kw)
    params = _flax_params(jmod, jnp.asarray(tokens))
    want = jmod.apply(params, jnp.asarray(tokens))
    tmod = _load(clip_text.ClipTextTransformer(**kw), convert.clip_text(params["params"], 2))
    with torch.no_grad():
        got = tmod(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_plan_recognition_transformer_matches_jax():
    from hulc2_tpu.models.distributions import PlanDistribution
    from hulc2_tpu.models.plan_nets import PlanRecognitionTransformer as JRec

    x = np.random.default_rng(3).standard_normal((2, 5, 128)).astype(np.float32)
    kw = dict(num_heads=8, num_layers=2, encoder_hidden_size=32, fc_hidden_size=40,
              max_position_embeddings=8, dropout_p=0.0)
    jmod = JRec(dist=PlanDistribution("discrete", 4, 5), **kw)
    params = _flax_params(jmod, jnp.asarray(x))
    (want_logits,), want_feat = jmod.apply(params, jnp.asarray(x))
    tmod = _load(plan_nets.PlanRecognitionTransformer(128, 20, **kw),
                 convert.plan_recognition_transformer(params["params"], 2))
    with torch.no_grad():
        logits, feat = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=ATOL)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), atol=ATOL)


def test_logistic_decoder_forward_matches_jax():
    from hulc2_tpu.models.decoders import LogisticPolicyDecoder as JDec

    rng = np.random.default_rng(4)
    plan = rng.standard_normal((2, 20)).astype(np.float32)
    emb = rng.standard_normal((2, 6, 128)).astype(np.float32)
    goal = rng.standard_normal((2, 8)).astype(np.float32)
    jmod = JDec(hidden_size=32)
    params = _flax_params(jmod, *map(jnp.asarray, (plan, emb, goal)))
    want = jmod.apply(params, *map(jnp.asarray, (plan, emb, goal)))
    tmod = _load(decoders.LogisticPolicyDecoder(20 + 64 + 8, hidden_size=32),
                 convert.action_decoder(params["params"]))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, (plan, emb, goal)))
    for name in ("logit_probs", "log_scales", "means", "gripper_logits", "hidden"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL, err_msg=name)


def test_hulc2_forward_metrics_match_jax(monkeypatch):
    """The metrics dict of ``Hulc2.forward`` against the JAX ``__call__`` on
    one fused batch, same weights, crop offsets and Gumbel draws."""
    holder = install_gumbel_rsample(monkeypatch)
    cfg = small_config()
    jmodel, params, tmodel = build_both(cfg)
    rng = np.random.default_rng(11)
    raw = make_raw_batch(rng, cfg)
    offsets, gumbel = make_draws(rng, cfg)
    holder["g"] = jnp.asarray(gumbel)
    want = jax.jit(lambda p, b: jmodel.apply(p, b, 0.01, False, 2,
                                             rngs={"sample": jax.random.PRNGKey(0)}))(
        params, jax_batch(raw, offsets))

    dm = cfg["datamodule"]
    tf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"], dm["transforms"])
    traw = torch_raw(raw)
    batch = tf({k: torch.cat([traw["vis"][k], traw["lang"][k]]) for k in traw["vis"]}, None,
               shift_draws(offsets))
    batch.update({k: traw["lang"][k] for k in ("lang", "use_for_aux_lang_loss", "lang_task_id")})
    with torch.no_grad():
        got = tmodel(batch, 0.01, 2, deterministic=False, gumbel=torch.from_numpy(gumbel))
    assert set(got) == set(want)
    for k in want:
        # the action NLL is a sum over 6 dims of log-likelihoods ~ -3 each
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_flax_to_torch_round_trips_through_jax_converters():
    """port state_dict -> ``convert_hulc2_checkpoint`` + ``convert_clip_text``
    + the task head's two layers gives back the original flax tree."""
    from hulc2_tpu.models.clip_text import convert_clip_text
    from hulc2_tpu.utils.convert import convert_hulc2_checkpoint, linear

    cfg = small_config()
    _, params, tmodel = build_both(cfg, seed=3)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    back = convert_hulc2_checkpoint(sd, cfg["model"])["params"]
    back["lang_net"], _ = convert_clip_text(
        {k[len("lang_net."):]: v for k, v in sd.items() if k.startswith("lang_net.")})
    back["lang_task_head"] = {n: linear(sd, f"lang_task_head.{n}") for n in ("fc0", "fc1")}
    want = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf), err_msg=str(path))


def test_flagship_config_equals_jax_composition():
    import hulc2_tpu.configs  # noqa: F401
    from hulc2_tpu.core import config as cfg_lib

    composed = cfg_lib.compose("cfg_low_level", list(FLAGSHIP_OVERRIDES))
    mine = flagship_config()

    def check(node, ref, path):
        for k, v in node.items():
            assert k in ref, f"{path}{k} missing from the JAX composition"
            if isinstance(v, dict):
                check(v, ref[k], f"{path}{k}.")
            else:
                assert v == ref[k], f"{path}{k}: {v!r} != {ref[k]!r}"

    check(mine, composed, "")
    assert set(mine["model"]) == set(composed["model"])
    # what the disk path reads: the dataset dir and the whole trainer section
    assert mine["datamodule"]["root_data_dir"] == composed["datamodule"]["root_data_dir"]
    assert mine["trainer"] == composed["trainer"]


def test_small_overrides_apply():
    cfg = flagship_config(SMALL_OVERRIDES)
    assert cfg["model"]["plan_proposal"]["hidden_size"] == 48
    assert cfg["model"]["compute_dtype"] == "float32"
    with pytest.raises(KeyError):
        flagship_config(["model.no_such_key=1"])


def test_build_policy_refuses_unported_options():
    """The tactile encoder, once refused here, builds and widens the
    embedding; an encoder neither package knows is refused by name."""
    cfg = flagship_config()
    cfg["model"]["perceptual_encoder"]["tactile"] = {"_name_": "tactile_encoder",
                                                     "visual_features": 64}
    model = build_policy(cfg["model"])
    assert model.perceptual_encoder.tactile_encoder is not None
    assert model.visual_goal.mlp[0].in_features == 64 * 3
    cfg["model"]["perceptual_encoder"]["tactile"] = {"_name_": "tactile_vit", "visual_features": 8}
    with pytest.raises(ValueError, match="tactile_vit"):
        build_policy(cfg["model"])
