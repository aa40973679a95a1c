"""Shared helpers of the affordance parity tests: seeded flax variables for a
JAX ``AffordanceDetector``, token ids, and a JAX/port detector pair of any
``aff_detection`` group carried over by ``detector_flax_to_torch``."""
import functools
import json

import numpy as np

import jax
import jax.numpy as jnp

import hulc2_tpu.configs  # noqa: F401  (registers the config groups)
import hulc2_tpu.configs.affordance  # noqa: F401
from hulc2_tpu.core import config as jax_cfg_lib
from hulc2_torch.affordance.train_affordance import build_detector
from hulc2_torch.configs.affordance import affordance_config
from hulc2_torch.utils.convert import detector_flax_to_torch

HW = 64
# the options tests' size: decoder (32, 16, 8, 8, 8), 64 px, 16-d language
SMALL = ("aff_detection.decoder_channels=[32,16,8,8,8]", "aff_detection.lang_embed_dim=16",
         "aff_detection.dataset.img_resize.static=64")


def tokens(rng, b):
    toks = np.zeros((b, 77), np.int32)
    for i in range(b):
        n = int(rng.integers(4, 12))
        toks[i, 0], toks[i, n - 1] = 49406, 49407
        toks[i, 1:n - 1] = rng.integers(1, 49000, n - 2)
    return toks


def random_variables(shapes, seed):
    """numpy values for the detector's flax variables: He-scaled kernels so the
    18-layer encoder neither explodes nor vanishes, BN scales near 1, random
    running means and variances."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "scale":
            return (1.0 + rng.uniform(-0.1, 0.1, shape)).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.2, 0.2, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "kernel" and len(shape) == 4:
            return (rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:-1]))).astype(np.float32)
        if name in ("kernel", "text_projection"):
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
        elif name == "bias":
            bound = 0.1
        else:  # token / position embeddings
            bound = 0.5
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def configs(group: str, overrides=()):
    """(JAX composition, the port's) of ``group`` with ``SMALL`` and ``overrides``."""
    ov = [f"aff_detection={group}", *SMALL, *overrides]
    return jax_cfg_lib.compose("train_affordance", ov), affordance_config(ov)


def lang_input(aff: dict, rng, b: int) -> np.ndarray:
    """Token ids for a token-tower detector, else float sentence embeddings."""
    if aff.get("text_tower"):
        return tokens(rng, b)
    return rng.standard_normal((b, aff["lang_embed_dim"])).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _shapes(aff_json: str):
    """The flax variables' shapes of the detector of ``aff_json``, traced once
    per config."""
    from hulc2_tpu.affordance.train_affordance import build_detector as jax_build

    aff = {**json.loads(aff_json), "freeze_encoder": True, "compute_dtype": None,
           "normalize_depth": True}
    jmodel = jax_build(aff)
    lang = jnp.zeros((1, 77), jnp.int32) if aff.get("text_tower") else jnp.zeros(
        (1, aff["lang_embed_dim"]))
    return jax.eval_shape(lambda k, i, l: jmodel.init(k, i, l, False), jax.random.PRNGKey(0),
                          jnp.zeros((1, HW, HW, 3)), lang)


def build_pair(group: str, overrides=(), seed: int = 0):
    """(JAX cfg, JAX model, flax variables, port model in eval mode, port cfg)
    with the same weights."""
    from hulc2_tpu.affordance.train_affordance import build_detector as jax_build

    jcfg, pcfg = configs(group, overrides)
    aff = jcfg["aff_detection"]
    jmodel = jax_build(aff)
    # none of these changes the variables' shapes
    same = {**aff, "freeze_encoder": None, "compute_dtype": None, "normalize_depth": None}
    variables = random_variables(_shapes(json.dumps(same, sort_keys=True)), seed)
    tmodel = build_detector(pcfg["aff_detection"])
    tmodel.load_state_dict(detector_flax_to_torch(variables, pcfg["aff_detection"]), strict=True)
    return jcfg, jmodel, variables, tmodel.eval(), pcfg
