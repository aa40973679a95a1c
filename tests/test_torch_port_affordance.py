"""The port's affordance model against the JAX package, on the CPU.

A small ``rn18_tokens_pixel`` detector (decoder channels (32, 16, 8, 8, 8), a
64-px input, a 2-layer text tower of width 32 with 2 heads) is built on both
sides: the JAX ``AffordanceDetector`` from the JAX config composition, its
flax variables filled with seeded numpy values (random BatchNorm statistics
included) and carried into the port by ``detector_flax_to_torch``. Frames,
token ids, crop offsets and normal draws are made with numpy or drawn from
the JAX keys and handed to both sides. Each test states its tolerance.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hulc2_tpu.configs  # noqa: F401  (registers the config groups)
import hulc2_tpu.configs.affordance  # noqa: F401
from hulc2_tpu.core import config as jax_cfg_lib
from hulc2_torch.affordance import dataset as port_dataset
from hulc2_torch.affordance import dataset_creation as port_mining
from hulc2_torch.affordance.depth_heads import DepthNorm
from hulc2_torch.affordance.detector import AffordancePredictor
from hulc2_torch.affordance.train_affordance import (
    SyntheticAffordanceDataset,
    build_detector,
    make_aff_train_step,
)
from hulc2_torch.configs.affordance import affordance_config
from hulc2_torch.ops.preprocess import resize
from hulc2_torch.train.optim import make_optimizer
from hulc2_torch.utils.convert import detector_flax_to_torch
from _torch_port_affordance import random_variables, tokens

REPO = Path(__file__).resolve().parents[1]
SMALL = (
    "aff_detection.decoder_channels=[32,16,8,8,8]",
    "aff_detection.lang_embed_dim=24",
    "aff_detection.tower_width=32",
    "aff_detection.tower_heads=2",
    "aff_detection.dataset.img_resize.static=64",
)
HW = 64


def jax_config(overrides=()):
    return jax_cfg_lib.compose("train_affordance", ["aff_detection=rn18_tokens_pixel", *overrides])


@pytest.fixture(scope="module")
def both():
    """(cfg, JAX model, flax variables, port model with the same weights)."""
    from hulc2_tpu.affordance.train_affordance import build_detector as jax_build

    cfg = jax_config(SMALL)
    jmodel = jax_build(cfg["aff_detection"])
    shapes = jax.eval_shape(lambda k, i, l: jmodel.init(k, i, l, False), jax.random.PRNGKey(0),
                            jnp.zeros((1, HW, HW, 3)), jnp.zeros((1, 77), jnp.int32))
    variables = random_variables(shapes, seed=0)
    port_cfg = affordance_config(SMALL)
    tmodel = build_detector(port_cfg["aff_detection"])
    tmodel.load_state_dict(detector_flax_to_torch(variables, port_cfg["aff_detection"]), strict=True)
    return cfg, jmodel, variables, tmodel.eval()


def test_config_equals_jax_composition():
    assert affordance_config(["aff_detection=rn18_tokens_pixel"]) == jax_config()
    assert affordance_config(SMALL) == jax_config(SMALL)
    assert affordance_config(["aff_detection=rn18_pixel"]) == jax_cfg_lib.compose(
        "train_affordance", ["aff_detection=rn18_pixel"])
    with pytest.raises(KeyError):
        affordance_config(["aff_detection.no_such_key=1"])


def test_resnet_pyramid_equals_jax(both):
    """Every level of the ResNet18 pyramid, atol 1e-4."""
    from hulc2_tpu.models.resnet import ResNet

    _, _, variables, tmodel = both
    enc = {k: variables[k]["aff_stream"]["encoder"] for k in ("params", "batch_stats")}
    img = np.random.default_rng(1).uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    want = jax.jit(ResNet("resnet18").apply)(enc, jnp.asarray(img))
    with torch.no_grad():
        got = tmodel.aff_stream.encoder(torch.from_numpy(img).permute(0, 3, 1, 2).contiguous())
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_detector_forward_and_loss_equal_jax(both):
    """Logits, depth mu and sigma within atol 1e-4; compute_loss within rtol 1e-5."""
    _, jmodel, variables, tmodel = both
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (3, HW, HW, 3)).astype(np.float32)
    toks = tokens(rng, 3)
    px = rng.integers(0, HW, (3, 2)).astype(np.int32)
    depth = rng.standard_normal(3).astype(np.float32)
    want = jax.jit(lambda v, i, t: jmodel.apply(v, i, t, False))(
        variables, jnp.asarray(img), jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img), torch.from_numpy(toks))
    assert got.hw == want.hw == (HW, HW)
    np.testing.assert_allclose(got.aff_logits.numpy(), np.asarray(want.aff_logits), atol=1e-4, rtol=0)
    for g, w in zip(got.depth_pred, want.depth_pred):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    j_total, j_metrics = jmodel.compute_loss(want, jnp.asarray(px), jnp.asarray(depth))
    t_total, t_metrics = tmodel.compute_loss(got, torch.from_numpy(px), torch.from_numpy(depth))
    np.testing.assert_allclose(t_total.item(), float(j_total), rtol=1e-5)
    for k in ("aff_loss", "depth_loss", "total_loss"):
        np.testing.assert_allclose(t_metrics[k].item(), float(j_metrics[k]), rtol=1e-5)


def test_predictor_equals_jax(both):
    """Pixels equal, heatmaps within 1e-5, depths equal to float32 rounding
    (rtol 1e-6) given the same normal draws; a batch of 3 equals 3 single
    calls; frames of mixed shapes are resized one by one."""
    from hulc2_tpu.affordance.detector import AffordancePredictor as JaxPredictor

    _, jmodel, variables, tmodel = both
    norm = DepthNorm(1.1, 0.2)
    jpred = JaxPredictor(jmodel, variables, norm, (HW, HW), seed=3)
    tpred = AffordancePredictor(tmodel, norm, (HW, HW), seed=3)
    rng = np.random.default_rng(4)
    langs = list(tokens(rng, 3))
    key = jax.random.PRNGKey(3)

    def jax_draws(call, cap):
        return torch.from_numpy(np.asarray(jax.random.normal(jax.random.fold_in(key, call), (cap, 1))))

    def compare(got, want):
        assert got["pixel"] == want["pixel"]
        np.testing.assert_allclose(got["softmax"], want["softmax"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-6)

    imgs = [rng.integers(0, 256, (48, 48, 3), np.uint8) for _ in range(3)]
    batch = tpred.predict_batch(imgs, langs, draws=jax_draws(1, 4)[:3])
    for got, want in zip(batch, jpred.predict_batch(imgs, langs)):
        compare(got, want)
    for i in range(3):
        single = tpred.predict_batch([imgs[i]], [langs[i]], draws=jax_draws(2 + i, 1))[0]
        compare(single, jpred.predict(imgs[i], langs[i]))
        assert single["pixel"] == batch[i]["pixel"]
        np.testing.assert_allclose(single["softmax"], batch[i]["softmax"], atol=1e-6, rtol=0)
    mixed = [rng.integers(0, 256, s, np.uint8) for s in ((48, 48, 3), (96, 96, 3), (64, 64, 3))]
    for got, want in zip(tpred.predict_batch(mixed, langs, draws=jax_draws(5, 4)[:3]),
                         jpred.predict_batch(mixed, langs)):
        compare(got, want)


@pytest.mark.parametrize("src,dst", [((96, 96), (224, 224)), ((48, 48), (64, 64)),
                                     ((224, 224), (96, 96)), ((200, 200), (84, 84)),
                                     ((96, 64), (224, 100)), ((64, 64), (64, 64))])
def test_resize_equals_jax_image_resize(src, dst):
    """Up- and down-scaling (antialiased triangle kernel) within 1e-5."""
    from hulc2_tpu.ops.preprocess import resize as jax_resize

    x = np.random.default_rng(sum(src + dst)).uniform(0, 1, (2, *src, 3)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), *dst))
    got = resize(torch.from_numpy(x), *dst).numpy()
    assert got.shape == want.shape == (2, *dst, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_jitter_equals_jax():
    """Image and label shifted by the offsets JAX draws from its key, exactly."""
    from hulc2_tpu.affordance.dataset import jitter_label_and_image as jax_jitter

    rng = np.random.default_rng(5)
    imgs = rng.uniform(0, 1, (6, 40, 40, 3)).astype(np.float32)
    px = np.concatenate([rng.integers(0, 40, (4, 2)), [[0, 39], [39, 0]]]).astype(np.int32)
    key, pad = jax.random.PRNGKey(6), 8
    want_imgs, want_px = jax_jitter(key, jnp.asarray(imgs), jnp.asarray(px), pad)
    offsets = np.asarray(jax.random.randint(key, (6, 2), 0, 2 * pad + 1), np.int32)
    got_imgs, got_px = port_dataset.jitter_label_and_image(
        torch.from_numpy(imgs), torch.from_numpy(px), torch.from_numpy(offsets), pad)
    np.testing.assert_array_equal(got_imgs.numpy(), np.asarray(want_imgs))
    np.testing.assert_array_equal(got_px.numpy(), np.asarray(want_px))


def _state_np(model):
    return {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}


def test_three_train_steps_equal_jax(both):
    """Three steps on the same batches and offsets: losses within rtol 1e-4;
    the trainable parameters and the decoder's BatchNorm statistics within
    rtol 1e-4 (atol 1e-5, a tenth of one Adam step at lr 1e-4), but for the
    entries whose gradient lies below the backward's fp32 noise (about 2e-6
    against gradients of 1e-2 here): Adam divides each gradient by its own
    scale, so such an entry can step either way (the seg head's bias is one:
    a softmax does not see a shift of all logits, so its gradient is zero
    but for rounding). Those may be at most 0.1% of the trainable entries
    and must stay within 6e-4, the most two 3-step Adam runs at lr 1e-4 can
    part. The encoder's parameters and statistics stay bit for bit
    unchanged."""
    from hulc2_tpu.affordance.train_affordance import make_aff_train_step as jax_make_step
    from hulc2_tpu.train import optim as jax_optim

    cfg, jmodel, variables, _ = both
    aff, pad = cfg["aff_detection"], cfg["rand_shift_pad"]
    port_cfg = affordance_config(SMALL)
    tmodel = build_detector(port_cfg["aff_detection"])
    tmodel.load_state_dict(detector_flax_to_torch(variables, port_cfg["aff_detection"]))
    before = _state_np(tmodel)
    opt = make_optimizer([p for p in tmodel.parameters() if p.requires_grad], aff["optimizer"])
    t_step = make_aff_train_step(tmodel, opt, aff["loss_weights"], HW, pad)
    tx = jax_optim.make_optimizer(aff["optimizer"])
    j_step = jax_make_step(jmodel, tx, aff["loss_weights"], HW, pad)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    opt_state = tx.init(params)
    ds = SyntheticAffordanceDataset(12, 48, 24, seed=7, lang_tokens=True)
    for s in range(3):
        items = [ds[4 * s + i] for i in range(4)]
        raw = {k: np.stack([it[k] for it in items]) for k in ("frame", "px", "normalized_depth", "lang")}
        raw["px"] = (raw["px"] * HW // 48).astype(np.int32)
        key = jax.random.PRNGKey(10 + s)
        offsets = np.asarray(jax.random.randint(key, (4, 2), 0, 2 * pad + 1), np.int32)
        params, stats, opt_state, j_metrics = j_step(
            params, stats, opt_state, {k: jnp.asarray(v) for k, v in raw.items()}, key)
        t_metrics = t_step({k: torch.from_numpy(v) for k, v in raw.items()}, torch.from_numpy(offsets))
        for k in ("aff_loss", "depth_loss", "total_loss"):
            np.testing.assert_allclose(t_metrics[k].item(), float(j_metrics[k]), rtol=1e-4)
    want = detector_flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, params),
                                   "batch_stats": jax.tree_util.tree_map(np.asarray, stats)},
                                  port_cfg["aff_detection"])
    got = _state_np(tmodel)
    moved = n_off = n_trained = 0
    for k, w in want.items():
        if k.startswith("aff_stream.encoder."):
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            np.testing.assert_array_equal(got[k], w.numpy(), err_msg=k)
        else:
            n_off += int((~np.isclose(got[k], w.numpy(), rtol=1e-4, atol=1e-5)).sum())
            n_trained += w.numel()
            np.testing.assert_allclose(got[k], w.numpy(), rtol=0, atol=6e-4, err_msg=k)
            moved += not np.array_equal(got[k], before[k])
    assert n_off <= 1e-3 * n_trained, (n_off, n_trained)
    assert moved > len(want) // 3
    assert not any(p.requires_grad for p in tmodel.aff_stream.encoder.parameters())


@pytest.fixture(scope="module")
def expert_dir(tmp_path_factory):
    """A small expert dataset from the port's generator (96/64 px, tokens)."""
    from hulc2_torch.tools import make_expert_dataset

    d = tmp_path_factory.mktemp("expert")
    make_expert_dataset.main([str(d), "--episodes", "1", "--tasks-per-episode", "6",
                              "--val-episodes", "1", "--val-tasks-per-episode", "3",
                              "--lang-tokens", "--holdout-paraphrases", "4", "--seed", "0"])
    return d


def _npz(path):
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def test_mined_labels_and_split_equal_jax(expert_dir, tmp_path):
    """Each split mined by both packages into its own dir: the same labels,
    the same npz contents; the validation episodes carry the port's
    ``validation_`` prefix. ``episodes_split.json`` equal for the same input."""
    from hulc2_tpu.affordance import dataset_creation as jax_mining
    from hulc2_tpu.envs.fake_env import FakeCalvinEnv as JaxEnv

    cam_port = port_mining.dataset_camera(expert_dir)
    cam_jax = JaxEnv(static_hw=96, gripper_hw=96).cameras[0]
    np.testing.assert_array_equal(cam_port.K, cam_jax.K)
    mined = {}
    for split in ("training", "validation"):
        ours = port_mining.mine_labels(expert_dir / split, tmp_path / "port", cam_port, split,
                                       holdout_k=4)
        theirs = jax_mining.mine_labels(expert_dir / split, tmp_path / f"jax_{split}", cam_jax,
                                        split, holdout_k=4)
        prefix = "" if split == "training" else "validation_"
        assert ours["depths"] == theirs["depths"] and len(ours["depths"]) > 0
        assert ours["episodes"] == {prefix + ep: f for ep, f in theirs["episodes"].items()}
        for ep, files in theirs["episodes"].items():
            for f in files:
                a = _npz(tmp_path / "port" / (prefix + ep) / "data" / "static_cam" / f"{f}.npz")
                b = _npz(tmp_path / f"jax_{split}" / ep / "data" / "static_cam" / f"{f}.npz")
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{ep}/{f}:{k}")
        mined[split] = ours
    info = port_mining.create_split_file(tmp_path / "port", mined)
    assert info == jax_mining.create_split_file(tmp_path / "jax_split", mined)
    assert (tmp_path / "port" / "episodes_split.json").read_text() == (
        tmp_path / "jax_split" / "episodes_split.json").read_text()
    # one training and one validation episode, no file shared between them
    train_files = {f"{ep}/{f}" for ep, c in info["training"].items() for f in c["static_cam"]}
    val_files = {f"{ep}/{f}" for ep, c in info["validation"].items() for f in c["static_cam"]}
    assert train_files and val_files and not train_files & val_files

    from hulc2_tpu.affordance.dataset import AffordanceDataset as JaxDataset
    from hulc2_torch.utils.clip_tokenizer import tokenize

    for split in ("training", "validation"):
        ours = port_dataset.AffordanceDataset(tmp_path / "port", split, img_resize=HW,
                                              lang_embedder=lambda a: tokenize([a])[0])
        theirs = JaxDataset(tmp_path / "port", split, img_resize=HW,
                            lang_embedder=lambda a: tokenize([a])[0])
        assert ours.depth_norm == tuple(theirs.depth_norm) and len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_mining_cli_keeps_splits_apart(expert_dir, tmp_path):
    """The CLI on a dataset whose splits both number their frames from 0:
    every listed label exists once, and a validation label holds the
    validation split's frame (the JAX package's would overwrite the
    training label of the same name)."""
    info = port_mining.main([str(expert_dir), "--out-dir", str(tmp_path / "aff"),
                             "--holdout-paraphrases", "4"])
    ep, files = next(iter(info["validation"].items()))
    assert ep.startswith("validation_episode_")
    first = _npz(tmp_path / "aff" / ep / "data" / "static_cam" / f"{files['static_cam'][0]}.npz")
    idx = int(files["static_cam"][0].split("_")[1])
    frame = np.load(expert_dir / "validation" / f"episode_{idx:07d}.npz")["rgb_static"]
    np.testing.assert_array_equal(first["frame"], frame)
    for split in ("training", "validation"):
        for e, c in info[split].items():
            for f in c["static_cam"]:
                assert (tmp_path / "aff" / e / "data" / "static_cam" / f"{f}.npz").is_file()


def test_synthetic_dataset_equals_jax():
    from hulc2_tpu.affordance.train_affordance import SyntheticAffordanceDataset as JaxSynthetic

    ours = SyntheticAffordanceDataset(5, 32, 24, seed=2, lang_tokens=True)
    theirs = JaxSynthetic(5, 32, 24, seed=2, lang_tokens=True)
    for i in range(5):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_new_modules_import_without_jax():
    mods = ["hulc2_torch", "hulc2_torch.affordance.detector", "hulc2_torch.affordance.lingunet",
            "hulc2_torch.affordance.train_affordance", "hulc2_torch.affordance.dataset",
            "hulc2_torch.affordance.dataset_creation", "hulc2_torch.affordance.fusion",
            "hulc2_torch.affordance.depth_heads", "hulc2_torch.models.resnet",
            "hulc2_torch.configs.affordance", "hulc2_torch.agents.approach",
            "hulc2_torch.evaluation.loading", "hulc2_torch.evaluation.evaluate_policy",
            "hulc2_torch.utils.convert", "hulc2_torch.affordance.losses",
            "hulc2_torch.affordance.train_depth", "hulc2_torch.affordance.merge_datasets",
            "hulc2_torch.tools.profile_affordance", "hulc2_torch.tools.auto_lang_annotator"]
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import " + ", ".join(mods)
            + "; bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'flax', 'optax', 'hulc2_tpu')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
