"""Shared pieces of the ``test_torch_port_*`` parity tests.

One small configuration of the flagship family feeds both packages: the JAX
``Hulc2`` is built from it by ``hulc2_tpu.models.build``, initialised by flax,
and its params are carried into the port with ``flax_to_torch``. Batches,
crop offsets and Gumbel draws are made with numpy and handed to both sides.
On the JAX side the train step is composed from public pieces
(``shift_from_offsets`` + ``scale_and_normalize``, ``Hulc2.apply``,
``optax.adam``), with ``PlanDistribution.rsample`` swapped for a version that
takes the given Gumbel draws.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.data.device_transforms import camera_sizes
from hulc2_torch.models.build import build_policy as torch_build_policy
from hulc2_torch.utils.convert import flax_to_torch

# narrow widths and few layers, flagship structure; fp32 and no dropout for parity
SMALL_OVERRIDES = (
    "model.plan_proposal.hidden_size=48",
    "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=40",
    "model.plan_recognition.dropout_p=0.0",
    "model.distribution.category_size=4",
    "model.distribution.class_size=5",
    "model.visual_goal.hidden_size=48",
    "model.visual_goal.latent_goal_features=8",
    "model.language_goal.hidden_size=48",
    "model.language_goal.latent_goal_features=8",
    "model.language_encoder.width=32",
    "model.language_encoder.heads=2",
    "model.language_encoder.output_dim=24",
    "model.action_decoder.hidden_size=32",
    "model.proj_vis_lang.output_dim=16",
    "model.lang_task_classes=6",
    "model.compute_dtype=\"float32\"",
    "datamodule.batch_size_vis=2",
    "datamodule.batch_size_lang=2",
    "datamodule.max_window_size=4",
)
SIZES = camera_sizes("rand_shift_96")
PADS = {"rgb_static": 4, "rgb_gripper": 3}


def small_config() -> dict:
    return flagship_config(SMALL_OVERRIDES)


def make_raw_batch(rng: np.random.Generator, cfg: dict) -> dict:
    """{"vis": ..., "lang": ...} numpy windows shaped like the port's synthetic data."""
    dm = cfg["datamodule"]
    s = dm["max_window_size"]
    n_tasks = cfg["model"]["lang_task_classes"]

    def window(b):
        actions = np.clip(rng.standard_normal((b, s, 7)) * 0.3, -1, 1).astype(np.float32)
        actions[..., -1] = np.sign(actions[..., -1] + 1e-6)
        return {
            "rgb_static": rng.integers(0, 256, (b, s, SIZES["rgb_static"], SIZES["rgb_static"], 3),
                                       dtype=np.uint8),
            "rgb_gripper": rng.integers(0, 256, (b, s, SIZES["rgb_gripper"], SIZES["rgb_gripper"], 3),
                                        dtype=np.uint8),
            "robot_obs_raw": rng.standard_normal((b, s, 15)).astype(np.float32),
            "actions": actions,
        }

    b = dm["batch_size_lang"]
    lang = window(b)
    toks = np.zeros((b, 77), np.int32)
    for i in range(b):
        n = int(rng.integers(4, 12))
        toks[i, 0], toks[i, n - 1] = 49406, 49407
        toks[i, 1:n - 1] = rng.integers(1, 49000, n - 2)
    lang["lang"] = toks
    lang["use_for_aux_lang_loss"] = np.array([True] + [bool(x) for x in rng.random(b - 1) > 0.5])
    lang["lang_task_id"] = rng.integers(0, n_tasks, b).astype(np.int32)
    return {"vis": window(dm["batch_size_vis"]), "lang": lang}


def make_draws(rng: np.random.Generator, cfg: dict) -> tuple:
    """(offsets per camera (N, 2) int32, Gumbel draws (B, categories, classes))."""
    dm, d = cfg["datamodule"], cfg["model"]["distribution"]
    n = (dm["batch_size_vis"] + dm["batch_size_lang"]) * dm["max_window_size"]
    offsets = {cam: rng.integers(0, 2 * pad + 1, (n, 2)).astype(np.int32)
               for cam, pad in PADS.items()}
    b = dm["batch_size_vis"] + dm["batch_size_lang"]
    gumbel = rng.gumbel(size=(b, d["category_size"], d["class_size"])).astype(np.float32)
    return offsets, gumbel


def shift_draws(offsets: dict) -> dict:
    """The batch transform's ``draws`` that give each camera's shift the
    (N, 2) int32 numpy ``offsets``: the shift is op 1 of the rand_shift and
    rand_shift_96 train pipelines (a val pipeline draws nothing at op 1)."""
    return {cam: {1: torch.from_numpy(off)} for cam, off in offsets.items()}


def fuse(raw: dict) -> dict:
    vis, lang = raw["vis"], raw["lang"]
    return {k: np.concatenate([vis[k], lang[k]]) for k in vis if k in lang}


@functools.partial(jax.jit, static_argnums=2)
def _jax_shift_normalize(imgs, offsets, pad):
    from hulc2_tpu.ops import preprocess

    b, s = imgs.shape[:2]
    flat = imgs.reshape(b * s, *imgs.shape[2:])
    x = preprocess.shift_from_offsets(offsets, flat, pad)
    x = preprocess.scale_and_normalize(x, [0.5], [0.5], jnp.float32)
    return x.reshape(b, s, *x.shape[1:])


def jax_batch(raw: dict, offsets: dict) -> dict:
    """The JAX package's fused model batch, transformed by its public ops."""
    fused = fuse(raw)
    return {
        "rgb_obs": {cam: _jax_shift_normalize(jnp.asarray(fused[cam]), jnp.asarray(offsets[cam]), pad)
                    for cam, pad in PADS.items()},
        "depth_obs": {},
        "robot_obs": jnp.asarray(fused["robot_obs_raw"][..., :8]),
        "robot_obs_raw": jnp.asarray(fused["robot_obs_raw"]),
        "actions": jnp.asarray(fused["actions"]),
        "lang": jnp.asarray(raw["lang"]["lang"]),
        "use_for_aux_lang_loss": jnp.asarray(raw["lang"]["use_for_aux_lang_loss"]),
        "lang_task_id": jnp.asarray(raw["lang"]["lang_task_id"]),
    }


def torch_raw(raw: dict) -> dict:
    return {m: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for m, d in raw.items()}


def install_gumbel_rsample(monkeypatch) -> dict:
    """Swap ``PlanDistribution.rsample`` for the straight-through sample with
    the Gumbel draws in the returned holder's "g" entry."""
    from hulc2_tpu.models.distributions import PlanDistribution

    holder = {}

    def rsample(self, rng, state):
        logits = self._logits(state)
        idx = jnp.argmax(logits + holder.get("g", 0.0), axis=-1)
        one_hot = jax.nn.one_hot(idx, self.class_size, dtype=logits.dtype)
        probs = jax.nn.softmax(logits, axis=-1)
        st = one_hot + probs - jax.lax.stop_gradient(probs)
        return st.reshape(*st.shape[:-2], -1)

    monkeypatch.setattr(PlanDistribution, "rsample", rsample)
    return holder


def random_flax_params(shapes, seed: int):
    """numpy values for a flax param tree of the given shapes: U(+-1/sqrt(fan_in))
    kernels, RNN weights U(+-1/sqrt(H)), LayerNorm scales near 1, small biases."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "logit_scale":
            return np.asarray(np.log(1 / 0.07), np.float32)
        if name == "scale":
            return (1.0 + rng.uniform(-0.1, 0.1, shape)).astype(np.float32)
        if name.startswith(("w_", "b_")):
            bound = 1 / np.sqrt(shape[-1])
        elif name in ("kernel", "text_projection"):
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
        elif name == "bias":
            bound = 0.1
        else:  # token / position embeddings
            bound = 0.5
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def build_both(cfg: dict, seed: int = 0):
    """(JAX model, flax params, port model with the same weights). The flax
    tree has the structure and shapes of ``Hulc2.init`` (traced, not run) and
    seeded numpy values; ``flax_to_torch`` carries it into the port."""
    import hulc2_tpu.configs  # noqa: F401  (registers the config groups)
    from hulc2_tpu.models.build import build_policy as jax_build_policy

    jmodel = jax_build_policy(cfg["model"])
    rng = np.random.default_rng(seed)
    raw = make_raw_batch(rng, cfg)
    offsets, _ = make_draws(rng, cfg)
    n_vis = cfg["datamodule"]["batch_size_vis"]
    keys = {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, 0.01, False, n_vis),
                            keys, jax_batch(raw, offsets))
    params = random_flax_params(shapes, seed)
    tmodel = torch_build_policy(cfg["model"], gripper_hw=SIZES["rgb_gripper"])
    tmodel.load_state_dict(flax_to_torch(params, cfg["model"]), strict=True)
    return jmodel, params, tmodel


def jax_train_step_fn(jmodel, lr: float, clip_beta: float, task_beta: float, n_vis: int, holder):
    """Jitted (params, opt_state, batch, gumbel, kl_beta) -> (params, opt_state, metrics)."""
    tx = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)

    def loss_fn(params, batch, kl_beta):
        metrics = jmodel.apply(params, batch, kl_beta, False, n_vis,
                               rngs={"sample": jax.random.PRNGKey(0)})
        loss = (metrics["total_loss"] + clip_beta * metrics["lang_clip_loss"]
                + task_beta * metrics["lang_task_loss"])
        metrics["loss"] = loss
        return loss, metrics

    @jax.jit
    def step(params, opt_state, batch, gumbel, kl_beta):
        holder["g"] = gumbel
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch, kl_beta)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics["grad_norm"] = jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(grads)))
        return params, opt_state, metrics

    return tx, step
