"""The real-robot root ``cfg_low_level_rw`` and the other pretrained-encoder
presets in the port against the JAX package, on the CPU in fp32.

The real-robot dataset layout (``rel_actions_gripper``, 6-channel tactile
frames) through the host loader equals JAX's batch for batch, the relative
gripper actions padded by repetition as JAX pads them. Three train steps of
``cfg_low_level_rw`` at tiny widths (its frozen R3M static stream, the
``real_world_r3m`` transform with JAX's own draws, 384-d sentence
embeddings) track the JAX step from the same weights (``flax_to_torch`` with
``batch_stats``): losses to rtol 1e-3, as the other configs' steps. With
Adam the frozen trunk stays as it was; with AdamW and gradient clipping it
is decayed exactly as optax decays it (ROADMAP C). The ``static_clip``,
``static_rgb_tactile`` and per-camera presets build and take a step.
``load_policy_from_torch_ckpt`` loads a Lightning-shaped checkpoint as
JAX's does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import hulc2_tpu.configs  # noqa: F401  (registers the JAX groups)
from _torch_port_common import install_gumbel_rsample, random_flax_params
from hulc2_torch.core import config as cfg_lib
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.data.device_transforms import TRANSFORM_PRESETS, make_batch_transform
from hulc2_torch.data.statistics import load_statistics
from hulc2_torch.models.build import build_policy_for
from hulc2_torch.train.optim import make_optimizer
from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step
from hulc2_torch.utils.convert import flax_to_torch
from test_torch_port_host_loader import EMB_DIM, write_low_level_dir
from test_torch_port_observation_space import jax_draws
from test_torch_port_pretrained import random_variables

RW_LANG = "lang_paraphrase-MiniLM-L3-v2"  # the root's lang_folder
RW_SMALL = [
    "model.plan_proposal.hidden_size=48", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=40", "model.plan_recognition.dropout_p=0.0",
    "model.distribution.category_size=4", "model.distribution.class_size=5",
    "model.visual_goal.hidden_size=48", "model.visual_goal.latent_goal_features=8",
    "model.language_goal.hidden_size=48", "model.language_goal.latent_goal_features=8",
    "model.action_decoder.hidden_size=32", "model.compute_dtype=\"float32\"",
    "datamodule.batch_size_vis=2", "datamodule.batch_size_lang=2",
    "datamodule.min_window_size=3", "datamodule.max_window_size=4", "datamodule.num_workers=2",
]
TACTILE_OBS = {"rgb_obs": ["rgb_static", "rgb_gripper", "rgb_tactile"],
               "depth_obs": ["depth_tactile"], "state_obs": ["robot_obs"],
               "actions": ["rel_actions_gripper"], "language": ["language"]}


@pytest.fixture(scope="module")
def rw_dir(tmp_path_factory):
    """TACO's layout at small sizes: 32 px static frames (``real_world_r3m``
    does not resize them), 84 px gripper frames, ``rel_actions_gripper``,
    6-channel ``rgb_tactile`` and 2-channel ``depth_tactile``, 384-d
    embeddings in the root's ``lang_folder``."""
    return write_low_level_dir(tmp_path_factory.mktemp("rw"), 32, 84,
                               action_key="rel_actions_gripper", tactile_hw=12,
                               lang_folder=RW_LANG)


def rw_config(root, extra=()) -> dict:
    return cfg_lib.compose("cfg_low_level_rw",
                           RW_SMALL + [f"datamodule.root_data_dir={root}", *extra])


def test_rw_layout_loader_equals_jax(rw_dir):
    """Every key of two epochs of fused batches, tactile rows and
    ``rel_actions_gripper`` included: not ``rel_actions``, so its padding
    repeats the last action (``window_dataset.py:60``, as in JAX)."""
    from hulc2_tpu.data.datamodule import Hulc2DataModule as JaxDataModule

    cfg = rw_config(rw_dir)["datamodule"]
    cfg["observation_space"] = TACTILE_OBS
    dm = Hulc2DataModule(cfg, seed=3, device="cpu")
    dm.setup()
    jdm = JaxDataModule(cfg, seed=3)
    jdm.setup()
    loader, ref = dm.fused_train_iter(), jdm.fused_train_iter()
    for epoch in range(2):
        for got, want in zip(loader, ref):
            assert set(got) == set(want)
            for k, w in want.items():
                assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
                np.testing.assert_array_equal(got[k], w, err_msg=f"epoch {epoch} {k}")
    assert got["rgb_tactile"].shape[-1] == 6 and got["depth_tactile"].shape[-1] == 2
    ds = dm.datasets["vis_training"]
    assert not ds.relative_actions
    short = [i for i in range(len(ds)) if ds[i]["seq_len"] < ds.padded_size]
    w = ds[short[0]]
    np.testing.assert_array_equal(w["actions"][w["seq_len"]:],
                                  np.repeat(w["actions"][w["seq_len"] - 1:w["seq_len"]],
                                            ds.padded_size - w["seq_len"], axis=0))


def _jax_rw(cfg: dict, raw: dict, key, seed: int):
    """(JAX model, its variables with random params and BatchNorm statistics,
    the JAX transform) of ``cfg``."""
    from hulc2_tpu.data import device_transforms as jdt
    from hulc2_tpu.data.statistics import load_statistics as jax_load
    from hulc2_tpu.models.build import build_policy as jax_build_policy

    dm = cfg["datamodule"]
    jtf = jdt.make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                   jax_load(f"{dm['root_data_dir']}/training"), dm["transforms"],
                                   train=True)
    jmodel = jax_build_policy(cfg["model"])
    batch = jtf(key, {k: jnp.asarray(v) for k, v in raw.items()})
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, 0.01, False, 2),
                            {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1),
                             "dropout": jax.random.PRNGKey(2)}, batch)
    variables = {"params": random_flax_params({"params": shapes["params"]}, seed)["params"],
                 "batch_stats": random_variables({"batch_stats": shapes["batch_stats"]},
                                                 seed)["batch_stats"]}
    return jmodel, variables, jtf


def _draws_for(cfg: dict, raw: dict, key) -> dict:
    dm = cfg["datamodule"]
    pipelines = TRANSFORM_PRESETS[dm["transforms"]]["train"]
    keys = list(dm["observation_space"]["rgb_obs"]) + list(dm["observation_space"]["depth_obs"])
    shapes = {k: (raw[k].shape[0] * raw[k].shape[1], *raw[k].shape[2:]) for k in keys}
    return jax_draws(key, pipelines, shapes)


@pytest.mark.parametrize("optimizer", ["adam", "adamw_clip"])
def test_three_rw_train_steps_track_jax(monkeypatch, rw_dir, optimizer):
    """Three fused batches of the host loader through both steps (JAX's
    transform and the port's with JAX's draws, the same Gumbel draws):
    losses and grad norms to rtol 1e-3. The frozen R3M trunk (and its
    BatchNorm statistics) is unchanged by Adam and decayed by AdamW with
    clipping exactly as optax decays it, to 1e-6 relative."""
    holder = install_gumbel_rsample(monkeypatch)
    extra = ([] if optimizer == "adam" else
             ["model/optimizer=adamw", "model.optimizer.weight_decay=0.1",
              "model.optimizer.gradient_clip_norm=0.5", "training.lr=0.001"])
    cfg = rw_config(rw_dir, extra)
    assert cfg["model"]["perceptual_encoder"]["rgb_static"]["_name_"] == "vision_r3m"
    dm_cfg, opt_cfg = cfg["datamodule"], cfg["model"]["optimizer"]
    dm = Hulc2DataModule(dm_cfg, seed=cfg["seed"], device="cpu")
    dm.setup()
    batches = iter(dm.fused_train_iter())
    raw = next(batches)
    assert raw["actions"].shape[-1] == 7 and raw["rgb_static"].shape[-3:] == (32, 32, 3)
    jmodel, var, jtf = _jax_rw(cfg, raw, jax.random.PRNGKey(9), seed=2)
    tmodel = build_policy_for(cfg)
    tmodel.load_state_dict(flax_to_torch(var, cfg["model"]), strict=True)
    trunk0 = {k: v.clone() for k, v in tmodel.perceptual_encoder.rgb_static_encoder.r3m
              .state_dict().items()}

    lr = opt_cfg["lr"]
    tx = (optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8) if optimizer == "adam" else
          optax.chain(optax.clip_by_global_norm(opt_cfg["gradient_clip_norm"]),
                      optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8,
                                  weight_decay=opt_cfg["weight_decay"])))
    stats = var["batch_stats"]

    def loss_fn(params, batch, kl_beta):
        m = jmodel.apply({"params": params, "batch_stats": stats}, batch, kl_beta, False, 2,
                         rngs={"sample": jax.random.PRNGKey(0)})
        m["loss"] = m["total_loss"]
        return m["loss"], m

    @jax.jit
    def jstep(params, opt_state, raw, key, gumbel, kl_beta):
        holder["g"] = gumbel
        batch = jtf(key, raw)
        (_, m), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch, kl_beta)
        m["grad_norm"] = jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(grads)))
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, m

    params, opt_state = var["params"], tx.init(var["params"])
    tf = make_batch_transform(dm_cfg["observation_space"], dm_cfg["proprioception_dims"],
                              dm_cfg["transforms"], stats=load_statistics(rw_dir / "training"))
    tstep = make_train_step(tmodel, make_optimizer(tmodel.parameters(), opt_cfg), tf,
                            cfg["loss"]["clip_auxiliary_loss_beta"],
                            aux_betas_from_loss_cfg(cfg["loss"]), device="cpu",
                            gradient_clip_norm=opt_cfg.get("gradient_clip_norm"))
    rng = np.random.default_rng(5)
    d, kl_beta = cfg["model"]["distribution"], cfg["loss"]["kl_beta"]
    for i in range(3):
        raw = raw if i == 0 else next(batches)
        key = jax.random.PRNGKey(100 + i)
        gumbel = rng.gumbel(size=(4, d["category_size"], d["class_size"])).astype(np.float32)
        params, opt_state, want = jstep(params, opt_state, {k: jnp.asarray(v) for k, v in raw.items()},
                                        key, jnp.asarray(gumbel), kl_beta)
        got = tstep({k: torch.from_numpy(v) for k, v in raw.items()}, None, kl_beta,
                    gumbel=torch.from_numpy(gumbel), draws=_draws_for(cfg, raw, key))
        assert "lang_clip_loss" not in got
        for name in ("loss", "total_loss", "action_loss", "kl_loss", "grad_norm"):
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-3, atol=1e-5,
                                       err_msg=f"step {i} {name}")
    trunk = tmodel.perceptual_encoder.rgb_static_encoder.r3m.state_dict()
    jtrunk = flax_to_torch({"params": params, "batch_stats": stats}, cfg["model"])
    decay = 1.0 if optimizer == "adam" else (1 - lr * opt_cfg["weight_decay"]) ** 3
    for k, v in trunk.items():
        buffer = "running" in k
        np.testing.assert_allclose(
            v.numpy(), jtrunk[f"perceptual_encoder.rgb_static_encoder.r3m.{k}"].numpy(),
            rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(v.numpy(), trunk0[k].numpy() * (1.0 if buffer else decay),
                                   rtol=1e-6, atol=0, err_msg=k)
    if optimizer != "adam":
        assert not torch.equal(trunk["conv1.weight"], trunk0["conv1.weight"])


# ---- the other presets ---------------------------------------------------- #
LOW = ["model.plan_proposal.hidden_size=48", "model.plan_recognition.encoder_hidden_size=32",
       "model.plan_recognition.fc_hidden_size=40", "model.plan_recognition.dropout_p=0.0",
       "model.distribution.category_size=4", "model.distribution.class_size=5",
       "model.visual_goal.hidden_size=48", "model.visual_goal.latent_goal_features=8",
       "model.language_goal.hidden_size=48", "model.language_goal.latent_goal_features=8",
       "model.action_decoder.hidden_size=32", "model.proj_vis_lang.output_dim=16",
       "model.compute_dtype=\"float32\"", "datamodule.batch_size_vis=2",
       "datamodule.batch_size_lang=2", "datamodule.min_window_size=2",
       "datamodule.max_window_size=3"]
CLIP_RN = 'model.perceptual_encoder.rgb_static.tower_kwargs={"layers": [1, 1, 1, 1], "width": 16, "heads": 4}'
CLIP_VIT = ('model.perceptual_encoder.rgb_static.tower_kwargs={"patch_size": 8, "width": 32, '
            '"layers": 1, "heads": 2, "output_dim": 24}')
PRESETS = {
    "static_clip_rn50": ["model/perceptual_encoder=static_clip", CLIP_RN],
    "static_clip_vit": ["model/perceptual_encoder=static_clip",
                        "model.perceptual_encoder.rgb_static.model_name=\"ViT-B/32\"", CLIP_VIT],
    "static_rgb_tactile": ["model/perceptual_encoder=static_rgb_tactile",
                           "datamodule/observation_space=lang_rgb_static_tactile_abs_act"],
    "static_r3m_gripper_resnet": ["model/perceptual_encoder/rgb_static=r3m",
                                  "model/perceptual_encoder/rgb_gripper=resnet"],
    "static_resnet_aff_gripper_r3m": ["model/perceptual_encoder/rgb_static=resnet_aff",
                                      "model/perceptual_encoder/rgb_gripper=r3m"],
    "gripper_resnet_aff": ["model/perceptual_encoder/rgb_gripper=resnet_aff"],
}
HW = {"rgb_static": 64, "rgb_gripper": 64, "rgb_tactile": 24}


def _model_batch(rng, cfg: dict) -> dict:
    """A transformed fused batch (float frames at ``HW``) of cfg's cameras."""
    dm = cfg["datamodule"]
    b, s = dm["batch_size_vis"] + dm["batch_size_lang"], dm["max_window_size"]
    rgb = {cam: rng.standard_normal((b, s, HW[cam], HW[cam], 6 if cam == "rgb_tactile" else 3))
           .astype(np.float32) for cam in dm["observation_space"]["rgb_obs"]}
    acts = np.clip(rng.standard_normal((b, s, 7)) * 0.3, -1, 1).astype(np.float32)
    acts[..., -1] = np.sign(acts[..., -1] + 1e-6)
    robot = rng.standard_normal((b, s, 15)).astype(np.float32)
    return {"rgb_obs": rgb, "depth_obs": {}, "robot_obs": robot[..., :8], "robot_obs_raw": robot,
            "actions": acts, "lang": rng.standard_normal((2, EMB_DIM)).astype(np.float32),
            "use_for_aux_lang_loss": np.array([True, False])}


def _torch_batch(batch: dict) -> dict:
    return {k: ({c: torch.from_numpy(v) for c, v in x.items()} if isinstance(x, dict)
                else torch.from_numpy(x)) for k, x in batch.items()}


@pytest.mark.parametrize("preset", list(PRESETS))
def test_preset_forward_equals_jax(monkeypatch, preset):
    """The policy of each preset on both sides from the same weights
    (``flax_to_torch`` with the trunks' ``batch_stats``): forward metrics to
    rtol 1e-4; then one port train step, finite, with no refusal."""
    from hulc2_tpu.models.build import build_policy as jax_build_policy

    from hulc2_torch.models.build import build_policy

    holder = install_gumbel_rsample(monkeypatch)
    cfg = cfg_lib.compose("cfg_low_level", LOW + PRESETS[preset])
    rng = np.random.default_rng(1)
    batch = _model_batch(rng, cfg)
    d = cfg["model"]["distribution"]
    gumbel = rng.gumbel(size=(4, d["category_size"], d["class_size"])).astype(np.float32)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jmodel = jax_build_policy(cfg["model"])
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, 0.01, False, 2),
                            {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
                             "dropout": jax.random.PRNGKey(2)}, jbatch)
    var = {"params": random_flax_params({"params": shapes["params"]}, 3)["params"]}
    if "batch_stats" in shapes:  # the ViT tower has no BatchNorm
        var["batch_stats"] = random_variables({"batch_stats": shapes["batch_stats"]},
                                              3)["batch_stats"]
    holder["g"] = jnp.asarray(gumbel)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, 0.01, False, 2,
                                             rngs={"sample": jax.random.PRNGKey(0)}))(var, jbatch)
    tmodel = build_policy(cfg["model"], static_hw=HW["rgb_static"], gripper_hw=HW["rgb_gripper"],
                          robot_obs_dim=8)
    tmodel.load_state_dict(flax_to_torch(var, cfg["model"]), strict=True)
    with torch.no_grad():
        got = tmodel(_torch_batch(batch), 0.01, 2, deterministic=False,
                     gumbel=torch.from_numpy(gumbel))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4, atol=1e-6, err_msg=k)


def _raw_window(rng, cfg: dict, hw: dict) -> dict:
    dm = cfg["datamodule"]
    s = dm["max_window_size"]

    def window(b):
        out = {cam: rng.integers(0, 256, (b, s, *hw[cam]), dtype=np.uint8)
               for cam in dm["observation_space"]["rgb_obs"]}
        out["robot_obs_raw"] = rng.standard_normal((b, s, 15)).astype(np.float32)
        out["actions"] = np.clip(rng.standard_normal((b, s, 7)) * 0.3, -1, 1).astype(np.float32)
        return out

    lang = window(2)
    lang.update(lang=rng.standard_normal((2, EMB_DIM)).astype(np.float32),
                use_for_aux_lang_loss=np.array([True, False]), lang_task_id=np.zeros(2, np.int32))
    return {"vis": window(2), "lang": lang}


@pytest.mark.parametrize("preset,transforms", [("static_rgb_tactile", "rand_shift"),
                                               ("static_clip_vit", "real_world_r3m"),
                                               ("gripper_resnet_aff", "real_world_r3m")])
def test_preset_trains_through_its_transform(preset, transforms):
    """A port train step from raw uint8 windows through the preset's
    transform: the 6-channel tactile frames resized (120 -> 70) and cropped
    to 64 as JAX's ``rand_shift`` tactile pipeline does; finite losses and a
    trunk the optimizer leaves alone where it is frozen."""
    hw = {"rgb_static": (200, 200, 3), "rgb_gripper": (84, 84, 3), "rgb_tactile": (120, 96, 6)}
    cfg = cfg_lib.compose("cfg_low_level", LOW + PRESETS[preset]
                          + [f"datamodule.transforms=\"{transforms}\""])
    dm = cfg["datamodule"]
    tmodel = build_policy_for(cfg)
    tf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"], transforms)
    step = make_train_step(tmodel, make_optimizer(tmodel.parameters(), cfg["model"]["optimizer"]),
                           tf, 3.0, device="cpu")
    raw = _raw_window(np.random.default_rng(2), cfg, hw)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    out = step({m: {k: torch.from_numpy(v) for k, v in b.items()} for m, b in raw.items()},
               torch.Generator().manual_seed(0), 0.01)
    assert all(torch.isfinite(v).all() for v in out.values())
    if preset == "static_rgb_tactile":
        batch = tf({k: torch.from_numpy(v) for k, v in raw["vis"].items()},
                   torch.Generator().manual_seed(0))
        assert batch["rgb_obs"]["rgb_tactile"].shape == (2, 3, 64, 64, 6)
    frozen = {"static_rgb_tactile": "tactile_encoder.trunk", "static_clip_vit": "rgb_static_encoder.clip",
              "gripper_resnet_aff": "rgb_gripper_encoder.resnet"}[preset]
    after = tmodel.state_dict()
    for k in before:
        if frozen in k:
            assert torch.equal(before[k], after[k]), k


def test_state_only_stays_refused_and_tactile_rollouts_are_refused():
    """``state_only`` has no ``rgb_static``, which JAX's ``ConcatEncoders``
    always encodes; the fake env renders no tactile frames."""
    from hulc2_torch.agents.hulc2_agent import Hulc2Agent

    dm = cfg_lib.compose("cfg_low_level", LOW + ["datamodule/observation_space=state_only"])
    with pytest.raises(NotImplementedError, match="state_only"):
        make_batch_transform(dm["datamodule"]["observation_space"],
                             dm["datamodule"]["proprioception_dims"], "rand_shift")
    cfg = cfg_lib.compose("cfg_low_level", LOW + PRESETS["static_rgb_tactile"])
    with pytest.raises(NotImplementedError, match="tactile"):
        Hulc2Agent(build_policy_for(cfg), cfg["datamodule"])


def test_lightning_checkpoint_loads_as_jax_loads_it(monkeypatch, tmp_path):
    """A reference-shaped ``.ckpt`` ({"state_dict", "hyper_parameters"},
    reference names) written from a random port policy of ``cfg_low_level``
    with ``lang_mlp``: the port's ``load_policy_from_torch_ckpt`` and JAX's
    give the same forward metrics, rtol 1e-4."""
    from hulc2_tpu.evaluation.loading import load_policy_from_torch_ckpt as jax_load

    from hulc2_torch.evaluation.loading import load_policy_from_torch_ckpt

    holder = install_gumbel_rsample(monkeypatch)
    cfg = cfg_lib.compose("cfg_low_level", LOW + ["model/language_encoder=mlp",
                                                  "model.language_encoder.hidden_size=32",
                                                  "model.language_encoder.out_features=24",
                                                  "datamodule.transforms=\"rand_shift_96\""])
    src = build_policy_for(cfg, seed=5)
    sd = {("lang_encoder." + k[len("lang_net."):] if k.startswith("lang_net.") else k): v
          for k, v in src.state_dict().items()}
    torch.save({"state_dict": sd, "hyper_parameters": {"lr": 1e-4}}, tmp_path / "ref.ckpt")
    model, hparams = load_policy_from_torch_ckpt(tmp_path / "ref.ckpt", cfg)
    assert hparams == {"lr": 1e-4}
    jmodel, jparams = jax_load(str(tmp_path / "ref.ckpt"), cfg)
    rng = np.random.default_rng(4)
    batch = _model_batch(rng, cfg)
    batch["rgb_obs"] = {cam: rng.standard_normal((4, 3, hw, hw, 3)).astype(np.float32)
                        for cam, hw in (("rgb_static", 96), ("rgb_gripper", 64))}
    d = cfg["model"]["distribution"]
    gumbel = rng.gumbel(size=(4, d["category_size"], d["class_size"])).astype(np.float32)
    holder["g"] = jnp.asarray(gumbel)
    want = jax.jit(lambda p, b: jmodel.apply(p, b, 0.01, False, 2,
                                             rngs={"sample": jax.random.PRNGKey(0)}))(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    with torch.no_grad():
        got = model(_torch_batch(batch), 0.01, 2, deterministic=False,
                    gumbel=torch.from_numpy(gumbel))
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4, atol=1e-6, err_msg=k)
    bad = dict(sd)
    bad.pop("plan_proposal.fc_model.0.weight")
    torch.save({"state_dict": bad}, tmp_path / "bad.ckpt")
    with pytest.raises(RuntimeError, match="Missing"):
        load_policy_from_torch_ckpt(tmp_path / "bad.ckpt", cfg)
