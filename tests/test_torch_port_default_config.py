"""The JAX package's default policy configuration, ``cfg_low_level``, in the
port, against the JAX package on the CPU.

The config registry (every root composed as JAX composes it, with and without
overrides; the flagship as the registry's composition), the ``rand_shift``
transform at 200/84 px with injected crop offsets, and the policy without a
text tower or task head: its forward metrics and three train steps on
batches of the host loader, both sides from the same weights
(``flax_to_torch``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import hulc2_tpu.configs  # noqa: F401  (registers the JAX groups)
from _torch_port_common import _jax_shift_normalize, random_flax_params, shift_draws
from hulc2_torch.configs.flagship import FLAGSHIP_OVERRIDES, flagship_config
from hulc2_torch.core import config as cfg_lib
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.data.device_transforms import camera_sizes, make_batch_transform
from hulc2_torch.data.statistics import load_statistics
from hulc2_torch.models.build import build_policy
from hulc2_torch.train.optim import make_optimizer
from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step
from hulc2_torch.utils.convert import flax_to_torch
from test_torch_port_host_loader import EMB_DIM, LOW_TINY, write_low_level_dir

from hulc2_tpu.core import config as jax_cfg_lib

SIZES = camera_sizes("rand_shift")
PADS = {"rgb_static": 10, "rgb_gripper": 4}
# cfg_low_level's structure at narrow widths, fp32, no dropout
LOW_SMALL = [
    "model.plan_proposal.hidden_size=48", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=40", "model.plan_recognition.dropout_p=0.0",
    "model.distribution.category_size=4", "model.distribution.class_size=5",
    "model.visual_goal.hidden_size=48", "model.visual_goal.latent_goal_features=8",
    "model.language_goal.hidden_size=48", "model.language_goal.latent_goal_features=8",
    "model.action_decoder.hidden_size=32", "model.proj_vis_lang.output_dim=16",
    "model.compute_dtype=\"float32\"", "datamodule.batch_size_vis=2",
    "datamodule.batch_size_lang=2", "datamodule.min_window_size=3",
    "datamodule.max_window_size=4", "datamodule.num_workers=2",
]
OVERRIDE_SETS = {
    "none": [],
    "values": ["datamodule.max_window_size=16", "training.lr=0.001", "loss.kl_beta=0.02",
               "model.language_goal.in_features=512"],
    "groups": ["model/language_encoder=clip_scratch", "model/distribution=continuous",
               "model/plan_recognition=bilstm", "datamodule/observation_space=lang_rgb_static_rel_act",
               "callbacks/kl_schedule=linear", "model/perceptual_encoder/rgb_gripper=none"],
}


# ---- the registry --------------------------------------------------------- #
@pytest.mark.parametrize("overrides", list(OVERRIDE_SETS), ids=list(OVERRIDE_SETS))
@pytest.mark.parametrize("root", ["cfg_low_level", "cfg_gcbc", "cfg_low_level_rw"])
def test_every_root_composes_as_jax(root, overrides):
    ov = OVERRIDE_SETS[overrides]
    assert cfg_lib.compose(root, ov) == jax_cfg_lib.compose(root, ov)


def test_registry_carries_every_policy_group():
    """Every root and every option of every group of the JAX registry, as the
    JAX registry has them, the affordance ones included: each package
    registers those when its ``configs.affordance`` module is imported."""
    import hulc2_torch.configs.affordance  # noqa: F401
    import hulc2_tpu.configs.affordance  # noqa: F401

    assert set(cfg_lib.options("root")) == set(jax_cfg_lib.options("root"))
    assert set(cfg_lib._GROUPS) == set(jax_cfg_lib._GROUPS)
    for group in cfg_lib._GROUPS:
        assert cfg_lib._GROUPS[group] == jax_cfg_lib._GROUPS[group], group
    assert len(cfg_lib._GROUPS) >= 20


def test_flagship_is_the_registry_composition():
    extra = ["model.plan_proposal.hidden_size=64", "datamodule.max_window_size=8"]
    assert flagship_config(extra) == jax_cfg_lib.compose("cfg_low_level",
                                                         list(FLAGSHIP_OVERRIDES) + extra)
    # an override applies before the interpolations resolve, as in JAX
    assert flagship_config(extra)["model"]["plan_recognition"]["max_position_embeddings"] == 8


def test_overrides_refuse_unknown_keys_and_options(tmp_path):
    for bad, err in (("model.no_such_key=1", KeyError), ("no_section.x=1", KeyError),
                     ("model/distribution=no_such_option", KeyError), ("model.kl_beta", ValueError)):
        with pytest.raises(err):
            cfg_lib.compose("cfg_low_level", [bad])
    cfg = cfg_lib.compose("cfg_low_level", ["seed=3"])
    cfg_lib.save_config(cfg, tmp_path / "run" / "config.json")
    assert cfg_lib.load_config(tmp_path / "run" / "config.json") == cfg and cfg["seed"] == 3


# ---- the rand_shift transform -------------------------------------------- #
@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_rand_shift_transform_equals_jax(monkeypatch, low_dir, train):
    """The preset's plain path (the kernel's plain version on the CPU) at
    200/84 px against JAX's ``make_batch_transform(..., "rand_shift")`` with
    the same crop offsets and the split's statistics: fp32, atol 1e-6."""
    import hulc2_tpu.data.device_transforms as jdt
    from hulc2_tpu.data.statistics import load_statistics as jax_load
    from hulc2_tpu.ops import preprocess as jprep

    cfg = cfg_lib.compose("cfg_low_level")["datamodule"]
    rng = np.random.default_rng(3)
    b, s = 2, 3
    raw = {cam: rng.integers(0, 256, (b, s, hw, hw, 3), dtype=np.uint8) for cam, hw in SIZES.items()}
    raw["robot_obs_raw"] = rng.standard_normal((b, s, 15)).astype(np.float32)
    raw["actions"] = rng.standard_normal((b, s, 7)).astype(np.float32)
    offsets = {cam: rng.integers(0, 2 * pad + 1, (b * s, 2)).astype(np.int32)
               for cam, pad in PADS.items()}
    by_pad = {PADS[cam]: jnp.asarray(off) for cam, off in offsets.items()}
    monkeypatch.setattr(jprep, "random_shift",
                        lambda key, x, pad: jprep.shift_from_offsets(by_pad[pad], x, pad))
    jtf = jdt.make_batch_transform(cfg["observation_space"], cfg["proprioception_dims"],
                                   jax_load(low_dir / "training"), "rand_shift", train=train)
    want = jtf(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in raw.items()})
    tf = make_batch_transform(cfg["observation_space"], cfg["proprioception_dims"], "rand_shift",
                              train=train, stats=load_statistics(low_dir / "training"))
    got = tf({k: torch.from_numpy(v) for k, v in raw.items()}, None, shift_draws(offsets))
    for cam in SIZES:
        assert got["rgb_obs"][cam].shape == (b, s, SIZES[cam], SIZES[cam], 3)
        np.testing.assert_allclose(got["rgb_obs"][cam].numpy(), np.asarray(want["rgb_obs"][cam]),
                                   atol=1e-6, rtol=0, err_msg=cam)
    np.testing.assert_allclose(got["robot_obs"].numpy(), np.asarray(want["robot_obs"]), atol=1e-6)
    # frames of another size go through the preset's resize (ported since;
    # once refused here): 96 px static frames come out at 200 px
    small = {**raw, "rgb_static": np.ascontiguousarray(raw["rgb_static"][:, :, :96, :96])}
    out = tf({k: torch.from_numpy(v) for k, v in small.items()}, None, shift_draws(offsets))
    assert out["rgb_obs"]["rgb_static"].shape == (b, s, 200, 200, 3)
    if not train:  # no shift: the resize and normalize alone, against JAX's
        want = jtf(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in small.items()})
        np.testing.assert_allclose(out["rgb_obs"]["rgb_static"].numpy(),
                                   np.asarray(want["rgb_obs"]["rgb_static"]), atol=1e-5, rtol=0)


# ---- the policy without a text tower -------------------------------------- #
@pytest.fixture(scope="module")
def low_dir(tmp_path_factory):
    return write_low_level_dir(tmp_path_factory.mktemp("default_cfg"))


def low_small_config(root=None) -> dict:
    extra = [] if root is None else [f"datamodule.root_data_dir={root}"]
    return cfg_lib.compose("cfg_low_level", LOW_SMALL + extra)


def _raw_batch(rng, b_vis, b_lang, s) -> dict:
    def window(b):
        acts = np.clip(rng.standard_normal((b, s, 7)) * 0.3, -1, 1).astype(np.float32)
        acts[..., -1] = np.sign(acts[..., -1] + 1e-6)
        out = {cam: rng.integers(0, 256, (b, s, hw, hw, 3), dtype=np.uint8) for cam, hw in SIZES.items()}
        out.update(robot_obs_raw=rng.standard_normal((b, s, 15)).astype(np.float32), actions=acts)
        return out

    fused = {k: np.concatenate([a, b]) for (k, a), b in
             zip(window(b_vis).items(), window(b_lang).values())}
    fused.update(lang=rng.standard_normal((b_lang, EMB_DIM)).astype(np.float32),
                 use_for_aux_lang_loss=np.array([True] + [False] * (b_lang - 1)),
                 lang_task_id=np.zeros(b_lang, np.int32))
    return fused


def _jax_batch(fused: dict, offsets: dict, robot_obs) -> dict:
    return {
        "rgb_obs": {cam: _jax_shift_normalize(jnp.asarray(fused[cam]), jnp.asarray(offsets[cam]), pad)
                    for cam, pad in PADS.items()},
        "depth_obs": {},
        "robot_obs": jnp.asarray(robot_obs),
        "robot_obs_raw": jnp.asarray(fused["robot_obs_raw"]),
        "actions": jnp.asarray(fused["actions"]),
        "lang": jnp.asarray(fused["lang"]),
        "use_for_aux_lang_loss": jnp.asarray(fused["use_for_aux_lang_loss"]),
    }


def _offsets(rng, n: int) -> dict:
    return {cam: rng.integers(0, 2 * pad + 1, (n, 2)).astype(np.int32) for cam, pad in PADS.items()}


def build_low_both(cfg: dict, seed: int = 0):
    """(JAX model, flax params, port model with the same weights) of a policy
    without a text tower or task head."""
    from hulc2_tpu.models.build import build_policy as jax_build_policy

    jmodel = jax_build_policy(cfg["model"])
    rng = np.random.default_rng(seed)
    fused = _raw_batch(rng, 2, 2, cfg["datamodule"]["max_window_size"])
    keys = {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    batch = _jax_batch(fused, _offsets(rng, 4 * fused["actions"].shape[1]),
                       fused["robot_obs_raw"][..., :8])
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, 0.01, False, 2), keys, batch)
    params = random_flax_params(shapes, seed)
    assert "lang_net" not in params["params"] and "lang_task_head" not in params["params"]
    tmodel = build_policy(cfg["model"], gripper_hw=SIZES["rgb_gripper"])
    tmodel.load_state_dict(flax_to_torch(params, cfg["model"]), strict=True)
    return jmodel, params, tmodel


def test_low_level_forward_matches_jax(monkeypatch):
    """One forward of the fused batch, same weights, offsets and Gumbel
    draws: the same metric keys as JAX (no task CE) and values to rtol 1e-4;
    the goal MLP takes the 384-d embedding and no tower or head is built."""
    from _torch_port_common import install_gumbel_rsample

    holder = install_gumbel_rsample(monkeypatch)
    cfg = low_small_config()
    jmodel, params, tmodel = build_low_both(cfg, seed=4)
    assert tmodel.lang_net is None and tmodel.lang_task_head is None
    assert tmodel.language_goal.mlp[1].weight.shape[1] == EMB_DIM
    rng = np.random.default_rng(6)
    s = cfg["datamodule"]["max_window_size"]
    fused = _raw_batch(rng, 2, 2, s)
    offsets = _offsets(rng, 4 * s)
    d = cfg["model"]["distribution"]
    gumbel = rng.gumbel(size=(4, d["category_size"], d["class_size"])).astype(np.float32)
    holder["g"] = jnp.asarray(gumbel)
    tf = make_batch_transform(cfg["datamodule"]["observation_space"],
                              cfg["datamodule"]["proprioception_dims"], "rand_shift")
    batch = tf({k: torch.from_numpy(v) for k, v in fused.items()}, None, shift_draws(offsets))
    want = jax.jit(lambda p, b: jmodel.apply(p, b, 0.01, False, 2,
                                             rngs={"sample": jax.random.PRNGKey(0)}))(
        params, _jax_batch(fused, offsets, batch["robot_obs"].numpy()))
    with torch.no_grad():
        got = tmodel(batch, 0.01, 2, deterministic=False, gumbel=torch.from_numpy(gumbel))
    assert set(got) == set(want) and "lang_task_loss" not in got
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4, atol=1e-6, err_msg=k)
    # lang_mlp, once refused here, builds its trainable MLP over the 384-d embeddings
    mlp = build_policy(cfg_lib.compose("cfg_low_level", ["model/language_encoder=mlp"])["model"])
    assert mlp.lang_net.mlp[1].in_features == EMB_DIM
    # the pretrained encoders, once refused here, build (held to JAX in
    # test_torch_port_pretrained*.py)
    r3m = build_policy(cfg_lib.compose("cfg_low_level",
                                       ["model/perceptual_encoder/rgb_static=r3m"])["model"])
    assert type(r3m.perceptual_encoder.rgb_static_encoder).__name__ == "VisionR3M"


def test_three_low_level_train_steps_track_jax(monkeypatch, low_dir):
    """Three fused batches of the host ``FusedBatchLoader`` (npz files,
    native reads, 200/84 px, 384-d embeddings), the training split's
    statistics: the port's step against the JAX step on the same arrays,
    offsets and Gumbel draws, losses to rtol 1e-3."""
    from _torch_port_common import install_gumbel_rsample
    from hulc2_tpu.data.device_transforms import process_proprio as jprocess
    from hulc2_tpu.data.statistics import load_statistics as jax_load

    holder = install_gumbel_rsample(monkeypatch)
    cfg = low_small_config(low_dir)
    dm_cfg, loss_cfg = cfg["datamodule"], cfg["loss"]
    dm = Hulc2DataModule(dm_cfg, seed=cfg["seed"], device="cpu")
    dm.setup()
    jstats = jax_load(low_dir / "training")
    jmodel, params, tmodel = build_low_both(cfg, seed=1)
    clip_beta, lr = loss_cfg["clip_auxiliary_loss_beta"], cfg["model"]["optimizer"]["lr"]
    tx = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)

    def loss_fn(params, batch, kl_beta):
        m = jmodel.apply(params, batch, kl_beta, False, 2, rngs={"sample": jax.random.PRNGKey(0)})
        m["loss"] = m["total_loss"] + clip_beta * m["lang_clip_loss"]
        return m["loss"], m

    @jax.jit
    def jstep(params, opt_state, batch, gumbel, kl_beta):
        holder["g"] = gumbel
        (_, m), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch, kl_beta)
        updates, opt_state = tx.update(grads, opt_state, params)
        m["grad_norm"] = jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(grads)))
        return optax.apply_updates(params, updates), opt_state, m

    opt_state = tx.init(params)
    tf = make_batch_transform(dm_cfg["observation_space"], dm_cfg["proprioception_dims"],
                              dm_cfg["transforms"], stats=load_statistics(low_dir / "training"))
    tstep = make_train_step(tmodel, make_optimizer(tmodel.parameters(), cfg["model"]["optimizer"]),
                            tf, clip_beta, aux_betas_from_loss_cfg(loss_cfg), device="cpu")
    rng = np.random.default_rng(5)
    d = cfg["model"]["distribution"]
    batches = iter(dm.fused_train_iter())
    for i in range(3):
        raw = next(batches)
        assert raw["rgb_static"].shape == (4, 4, 200, 200, 3) and raw["lang"].shape == (2, EMB_DIM)
        offsets = _offsets(rng, 16)
        gumbel = rng.gumbel(size=(4, d["category_size"], d["class_size"])).astype(np.float32)
        robot = jprocess(jnp.asarray(raw["robot_obs_raw"]), jstats, dm_cfg["proprioception_dims"])
        params, opt_state, want = jstep(params, opt_state, _jax_batch(raw, offsets, robot),
                                        jnp.asarray(gumbel), loss_cfg["kl_beta"])
        got = tstep({k: torch.from_numpy(v) for k, v in raw.items()}, None, loss_cfg["kl_beta"],
                    gumbel=torch.from_numpy(gumbel), draws=shift_draws(offsets))
        assert "lang_task_loss" not in got
        for name in ("loss", "total_loss", "action_loss", "kl_loss", "lang_clip_loss", "grad_norm"):
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-3, atol=1e-5,
                                       err_msg=f"step {i} {name}")


def test_synthetic_cli_runs_the_default_config(tmp_path):
    """``--synthetic --config-name cfg_low_level``: synthetic windows at the
    preset's 200/84 px with 384-d embeddings for the policy without a tower."""
    from hulc2_torch import training

    result = training.main(["--synthetic", "--config-name", "cfg_low_level", "--max-steps", "2",
                            "--device", "cpu", "--run-dir", str(tmp_path), *LOW_TINY])
    assert len(result.history) == 2 and result.model.lang_net is None
    assert all(np.isfinite(v) for line in result.history for v in line.values())
