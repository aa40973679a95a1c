"""The policy's observation space in the port against the JAX package, on the CPU in fp32.

Every transform preset's train and val pipelines (``TRANSFORM_PRESETS``,
``hulc2_tpu/data/device_transforms.py:25-282``) over both RGB cameras, both
depth cameras and robot_obs with scene_obs, once at the sizes the presets
expect and once at sizes their resizes really change; JAX's
``make_batch_transform`` draws from its key, and the port gets the same
draws (``jax_draws``): outputs within 1e-5 of their scale. The new ops one by
one, ``FrameSkip.keep_ids``, the window datasets' and loaders' batches with
depth and scene_obs (equal after the cast of stored float16 depth), three
train steps of the new model options, rollouts of a depth policy and a
static-only policy through the fused render step, and the two faults of
the JAX package that this slice repairs: the eval's missing statistics and
scene_obs dropped on the fused paths.
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hulc2_tpu.configs  # noqa: F401  (registers the JAX groups)
import hulc2_torch.configs  # noqa: F401  (registers the port's groups)
from hulc2_torch.data import device_transforms as tdt
from hulc2_torch.data.statistics import DatasetStatistics
from hulc2_torch.ops import preprocess as tpre

PRESETS = list(tdt.TRANSFORM_PRESETS)
OBS_SPACE = {"rgb_obs": ["rgb_static", "rgb_gripper"], "depth_obs": ["depth_static", "depth_gripper"],
             "state_obs": ["robot_obs", "scene_obs"], "actions": ["rel_actions"],
             "language": ["language"]}
ROBOT_SCENE_DIMS = {"n_state_obs": 54, "keep_indices": [[0, 54]], "robot_orientation_idx": [3, 6],
               "normalize": True, "normalize_robot_orientation": True}
# frame sizes per case: the presets' own, and sizes every resize changes
FRAME_SIZES = {"native": {"rgb_static": 200, "rgb_gripper": 84, "depth_static": 200,
                          "depth_gripper": 84},
               "resized": {"rgb_static": 96, "rgb_gripper": 64, "depth_static": 96,
                           "depth_gripper": 64}}


def _stats(rng) -> DatasetStatistics:
    return DatasetStatistics(
        robot_obs_mean=rng.standard_normal(15).astype(np.float32),
        robot_obs_std=rng.uniform(0.5, 2.0, 15).astype(np.float32),
        scene_obs_mean=rng.standard_normal(24).astype(np.float32),
        scene_obs_std=np.concatenate([rng.uniform(0.5, 2.0, 23), [0.0]]).astype(np.float32))


def _resized_shape(shape, size):
    n, h, w, c = shape
    if h <= w:
        return n, size, max(1, round(w * size / h)), c
    return n, max(1, round(h * size / w)), size, c


def jax_draws(key, pipelines: dict, shapes: dict) -> dict:
    """The draws JAX's ``_apply_ops`` takes from ``key`` for each key's
    pipeline, as the port's ``draws`` (key -> {op index: array}); ``shapes``
    holds each key's (N, H, W, C) input frames."""
    from hulc2_tpu.core import prng

    out = {}
    for name, shape in shapes.items():
        k_cam, got = prng.stream(key, name), {}
        for i, op in enumerate(pipelines.get(name, [])):
            k, kind = jax.random.fold_in(k_cam, i), op["op"]
            n, h, w, _ = shape
            if kind == "resize" and (h, w) != (op["size"], op["size"]):
                shape = _resized_shape(shape, op["size"])
            elif kind in ("random_shift", "random_shift_float"):
                got[i] = jax.random.randint(k, (n, 2), 0, 2 * op["pad"] + 1)
            elif kind == "random_crop":
                got[i] = jnp.stack([jax.random.randint(k, (n,), 0, h - op["size"] + 1),
                                    jax.random.randint(jax.random.fold_in(k, 1), (n,), 0,
                                                       w - op["size"] + 1)], axis=-1)
                shape = (n, op["size"], op["size"], shape[-1])
            elif kind == "gaussian_noise":
                got[i] = jax.random.normal(k, shape, jnp.float32)
            elif kind == "depth_noise":
                got[i] = (jax.random.gamma(k, jnp.float32(op.get("shape", 1000.0)))
                          / jnp.float32(op.get("rate", 1000.0)))
            elif kind == "color_jitter":
                got[i] = jnp.stack([jax.random.uniform(s, ()) for s in jax.random.split(k, 4)])
        out[name] = {i: torch.from_numpy(np.array(v)).to(torch.int32 if v.dtype == jnp.int32
                                                         else torch.float32)
                     for i, v in got.items()}
    return out


def _raw_window(rng, sizes: dict, b: int = 2, s: int = 3) -> dict:
    raw = {cam: rng.integers(0, 256, (b, s, sizes[cam], sizes[cam], 3), dtype=np.uint8)
           for cam in ("rgb_static", "rgb_gripper")}
    for cam in ("depth_static", "depth_gripper"):  # stored float16
        raw[cam] = rng.uniform(0.5, 2.5, (b, s, sizes[cam], sizes[cam])).astype(np.float16)
    raw["robot_obs_raw"] = rng.standard_normal((b, s, 15)).astype(np.float32)
    raw["scene_obs"] = rng.standard_normal((b, s, 24)).astype(np.float32)
    raw["actions"] = rng.standard_normal((b, s, 7)).astype(np.float32)
    return raw


def _close_scaled(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


# ---- the presets --------------------------------------------------------- #
def _bf16_step(pipeline: list) -> float:
    """An output's change for one bf16 step (1.0) of a pixel value below
    256 before the pipeline's normalising ops, with a margin of 1.25 for
    the colour jitter's brightness, contrast and hue (each near 1)."""
    gain = 1.0 / 255
    for op in pipeline:
        if op["op"] in ("scale_normalize", "normalize"):
            gain /= min(op["std"])
    return 1.25 * gain


@pytest.mark.parametrize("case", list(FRAME_SIZES))
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("preset", PRESETS)
def test_transform_preset_matches_jax(monkeypatch, preset, split, case):
    """Every key of the batch, from JAX's key and the same draws: images,
    depth maps and robot_obs (normalised robot_obs ++ scene_obs with one
    zero std) within 1e-5 of their scale, against the unchanged JAX
    package, when the port's pipeline is given JAX's resize values (the
    resize alone: ``test_resize_shorter_edge_matches_jax``). With its own
    resize, frames resized and then shifted as bf16 differ from JAX's at
    fewer than 1e-3 of the elements, by at most one bf16 step of a pixel
    (``_bf16_step``)."""
    from hulc2_tpu.data.device_transforms import make_batch_transform as jax_transform
    from hulc2_tpu.data.statistics import DatasetStatistics as JStats

    rng = np.random.default_rng(PRESETS.index(preset))
    stats = _stats(rng)
    raw = _raw_window(rng, FRAME_SIZES[case])
    train = split == "train"
    key = jax.random.PRNGKey(7)
    jraw = {k: jnp.asarray(v.astype(np.float32) if v.dtype == np.float16 else v)
            for k, v in raw.items()}
    want = jax.jit(jax_transform(OBS_SPACE, ROBOT_SCENE_DIMS, JStats(**vars(stats)), preset,
                                 train=train))(key, jraw)
    pipelines = tdt.TRANSFORM_PRESETS[preset][split]
    shapes = {k: (6, *raw[k].shape[2:4], 3 if k.startswith("rgb") else 1)
              for k in OBS_SPACE["rgb_obs"] + OBS_SPACE["depth_obs"]}
    draws = jax_draws(key, pipelines, shapes)
    tf = tdt.make_batch_transform(OBS_SPACE, ROBOT_SCENE_DIMS, preset, train=train, stats=stats)
    traw = {k: torch.from_numpy(v) for k, v in raw.items()}
    got = tf(traw, None, draws=draws)
    # the port's composition with JAX's resize values, so that frames a
    # resize makes float round to bf16 alike before their shift
    with monkeypatch.context() as m:
        m.setattr(tpre, "resize_shorter_edge", lambda x, size: torch.from_numpy(np.array(
            _jax_pre().resize_shorter_edge(jnp.asarray(x.float().numpy()), size))))
        same_resize = tf(traw, None, draws=draws)
    for group in ("rgb_obs", "depth_obs"):
        assert set(got[group]) == set(want[group])
        for k in want[group]:
            what = f"{preset} {split} {case} {k}"
            w = np.asarray(want[group][k])
            _close_scaled(same_resize[group][k], w, what)
            # the port's own resize agrees with JAX's to a few fp32 ulp; a
            # pixel between them at a bf16 rounding boundary rounds apart
            off = np.abs(got[group][k].numpy() - w) > 1e-5 * max(1.0, float(np.abs(w).max()))
            assert off.mean() < 1e-3, (what, off.mean())
            np.testing.assert_allclose(got[group][k].numpy(), w, rtol=0,
                                       atol=_bf16_step(pipelines.get(k, [])), err_msg=what)
    _close_scaled(got["robot_obs"], want["robot_obs"], "robot_obs")
    assert got["robot_obs"].shape[-1] == 39


def test_kernel_runs_cover_the_uint8_runs():
    """The runs of ops one shift_normalize launch computes on uint8 frames,
    per preset and camera at the presets' sizes: a resize must leave the
    size alone, float frames take no kernel."""
    frames = torch.zeros(1, 200, 200, 3, dtype=torch.uint8)
    grip = torch.zeros(1, 84, 84, 3, dtype=torch.uint8)
    p = tdt.TRANSFORM_PRESETS
    assert tdt.kernel_run(p["rand_shift"]["train"]["rgb_static"], 0, frames) == (3, 1, 10, [0.5], [0.5])
    assert tdt.kernel_run(p["rand_shift"]["val"]["rgb_gripper"], 0, grip) == (2, None, 0, [0.5], [0.5])
    assert tdt.kernel_run(p["real_world"]["train"]["rgb_static"], 0, frames) == \
        (1, None, 0, [0.0], [1.0])
    assert tdt.kernel_run(p["real_world"]["train"]["rgb_gripper"], 0, grip)[:3] == (2, None, 0)
    assert tdt.kernel_run(p["rand_shift_96"]["train"]["rgb_static"], 0, frames) is None  # resizes
    square = torch.zeros(1, 150, 200, 3, dtype=torch.uint8)  # the shorter edge is 150 already
    assert tdt.kernel_run(p["real_world_square"]["train"]["rgb_static"], 0, square) == \
        (3, 1, 6, [0.0], [1.0])
    assert tdt.kernel_run(p["rand_shift"]["train"]["rgb_static"], 0, frames.float()) is None


# ---- the new ops ---------------------------------------------------------- #
def _jax_pre():
    from hulc2_tpu.ops import preprocess

    return preprocess


def test_resize_shorter_edge_matches_jax():
    rng = np.random.default_rng(1)
    for h, w, size in ((96, 96, 200), (200, 200, 150), (150, 200, 84), (84, 60, 64)):
        x = rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
        want = _jax_pre().resize_shorter_edge(jnp.asarray(x), size)
        _close_scaled(tpre.resize_shorter_edge(torch.from_numpy(x), size), want, f"{h}x{w}->{size}")


def test_random_crop_and_float_shifts_match_jax():
    """``random_crop`` and ``random_shift_slices`` (exact) and ``random_shift``
    on float frames (rounded to bf16, as JAX's selection matmuls are) from
    JAX's own offsets."""
    pre = _jax_pre()
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 255, (5, 20, 24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = pre.random_crop(key, jnp.asarray(x), 16, 16)
    off = np.stack([np.array(jax.random.randint(key, (5,), 0, 5)),
                    np.array(jax.random.randint(jax.random.fold_in(key, 1), (5,), 0, 9))], -1)
    np.testing.assert_array_equal(tpre.random_crop(torch.from_numpy(x), torch.from_numpy(off), 16, 16)
                                  .numpy(), np.asarray(want))
    off = jax.random.randint(key, (5, 2), 0, 9)
    toff = torch.from_numpy(np.array(off))
    np.testing.assert_array_equal(
        tpre.shift_from_offsets(toff, torch.from_numpy(x), 4).numpy(),
        np.asarray(pre.random_shift_slices(key, jnp.asarray(x), 4)))


def test_random_shift_of_float_frames_rounds_to_bf16_as_jax():
    """After a resize that changes the size, ``_apply_ops`` hands
    ``random_shift`` float frames, and JAX's one-hot matmuls in bf16
    (``preprocess.py:86``) round every pixel to 8 significant bits, up to
    0.5 of 255. The port's transform rounds them alike (kept for parity):
    its shift op equals JAX's ``random_shift`` bit for bit on float frames,
    and both are exact on uint8 frames."""
    pre = _jax_pre()
    rng = np.random.default_rng(3)
    x = rng.uniform(128, 255, (4, 12, 12, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    toff = torch.from_numpy(np.array(jax.random.randint(key, (4, 2), 0, 5)))
    pipeline = [{"op": "random_shift", "pad": 2}]
    got = tdt._apply(pipeline, torch.from_numpy(x), {0: toff}, torch.float32, None).numpy()
    want = np.asarray(pre.random_shift(key, jnp.asarray(x), 2))
    np.testing.assert_array_equal(got, want)
    exact = tpre.shift_from_offsets(toff, torch.from_numpy(x), 2).numpy()
    assert 0.0 < np.abs(got - exact).max() <= 0.5
    u8 = x.astype(np.uint8)
    np.testing.assert_array_equal(
        tdt._apply(pipeline, torch.from_numpy(u8).float(), {0: toff}, torch.float32, None).numpy(),
        np.asarray(pre.random_shift(key, jnp.asarray(u8), 2)))


def test_noise_ops_match_jax():
    pre = _jax_pre()
    rng = np.random.default_rng(4)
    x = rng.uniform(0.5, 2.0, (3, 8, 8, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    _close_scaled(tpre.add_gaussian_noise(torch.from_numpy(x), torch.from_numpy(noise), 0.1, 0.01),
                  pre.add_gaussian_noise(key, jnp.asarray(x), 0.1, 0.01), "gaussian")
    gamma = np.array(jax.random.gamma(key, jnp.float32(1000.0)) / jnp.float32(1000.0))
    _close_scaled(tpre.add_depth_noise(torch.from_numpy(x), torch.from_numpy(gamma)),
                  pre.add_depth_noise(key, jnp.asarray(x)), "depth noise")


@pytest.mark.parametrize("prob", [1.0, 0.0])
def test_color_jitter_matches_jax(prob):
    """The YIQ hue rotation, contrast about each frame's mean, the clip, and
    the batch-wide coin (applied at prob 1, skipped at prob 0)."""
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (4, 6, 7, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = _jax_pre().color_jitter(key, jnp.asarray(x), 0.2, 0.3, 0.1, prob)
    u = np.stack([np.array(jax.random.uniform(k, ())) for k in jax.random.split(key, 4)])
    got = tpre.color_jitter(torch.from_numpy(x), torch.from_numpy(u), 0.2, 0.3, 0.1, prob)
    _close_scaled(got, want, f"jitter p={prob}")
    assert (prob == 0.0) == np.array_equal(got.numpy(), x)


def test_gamma_draw_has_the_gamma_moments():
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([tdt.draw_gamma(1000.0, g, "cpu") for _ in range(2000)])
    assert abs(draws.mean().item() - 1000.0) < 2.0 and abs(draws.std().item() - 1000.0 ** 0.5) < 3.0
    small = torch.stack([tdt.draw_gamma(0.5, g, "cpu") for _ in range(4000)])
    assert abs(small.mean().item() - 0.5) < 0.05


def test_process_proprio_with_scene_obs_matches_jax():
    """robot_scene keeps robot_obs ++ scene_obs (39 wide, not n_state_obs'
    54); with ``normalize_robot_orientation`` false the orientation stays raw."""
    from hulc2_tpu.data.device_transforms import process_proprio as jpp
    from hulc2_tpu.data.statistics import DatasetStatistics as JStats

    rng = np.random.default_rng(9)
    stats = _stats(rng)
    robot, scene = rng.standard_normal((2, 3, 15)).astype(np.float32), \
        rng.standard_normal((2, 3, 24)).astype(np.float32)
    for cfg in (ROBOT_SCENE_DIMS, {**ROBOT_SCENE_DIMS, "normalize_robot_orientation": False},
                {**ROBOT_SCENE_DIMS, "keep_indices": [[0, 7], [14, 20]]}):
        for st in (stats, DatasetStatistics(robot_obs_mean=stats.robot_obs_mean,
                                            robot_obs_std=stats.robot_obs_std)):
            want = jpp(jnp.asarray(robot), JStats(**vars(st)), cfg, jnp.asarray(scene))
            got = tdt.process_proprio(torch.from_numpy(robot), cfg, st, {},
                                      torch.from_numpy(scene))
            _close_scaled(got, want, str(cfg))


# ---- frame skipping ------------------------------------------------------- #
@pytest.mark.parametrize("strategy", ["random", "diff"])
def test_frame_skip_keep_ids_equal_jax(strategy):
    """The port's copy draws the same ids from the same generator, over
    windows of every raw length and gripper toggles."""
    from hulc2_tpu.data.frame_skip import make_frame_skip as jax_make

    from hulc2_torch.data.frame_skip import make_frame_skip

    cfg = frame_skip_option(strategy)
    port, jax_fs = make_frame_skip(cfg), jax_make(cfg)
    rng = np.random.default_rng(11)
    for case in range(60):
        ws = int(rng.integers(20, 33))
        acts = np.clip(rng.standard_normal((ws, 7)) * 0.2, -1, 1).astype(np.float32)
        acts[:, :3] = acts[:1, :3] + rng.standard_normal((ws, 3)).astype(np.float32) * 0.01
        acts[:, -1] = np.where(np.arange(ws) < rng.integers(0, ws), 1.0, -1.0)
        got = port.keep_ids(acts, 20, 32, np.random.default_rng(case))
        want = jax_fs.keep_ids(acts, 20, 32, np.random.default_rng(case))
        np.testing.assert_array_equal(got, want, err_msg=f"case {case}")
        assert len(got) == port.effective_size(ws, 20, 32)


def frame_skip_option(option: str) -> dict:
    """The registry's ``datamodule/frame_skip`` option."""
    from hulc2_torch.core import config as cfg_lib

    return cfg_lib.compose("cfg_low_level", [f"datamodule/frame_skip={option}"])["datamodule"][
        "frame_skip"]


# ---- datasets and loaders with depth and scene_obs ------------------------- #
OBS_DATA = {"rgb_obs": ["rgb_static", "rgb_gripper"], "depth_obs": ["depth_static"],
            "state_obs": ["robot_obs", "scene_obs"], "actions": ["rel_actions"],
            "language": ["language"]}


@pytest.fixture(scope="module")
def obs_dir(tmp_path_factory):
    """``write_calvin_dir``'s 16 px dataset with float16 depth_static,
    scene_obs and absolute actions in every frame, as the port's generator
    writes them."""
    from pathlib import Path

    from _torch_port_dataset import write_calvin_dir

    root = write_calvin_dir(tmp_path_factory.mktemp("obs_space"), 16, 16)
    rng = np.random.default_rng(5)
    for path in sorted(Path(root).glob("*/episode_*.npz")):
        with np.load(path) as z:
            frame = dict(z)
        frame["depth_static"] = rng.uniform(0.5, 2.5, (16, 16)).astype(np.float16)
        frame["scene_obs"] = rng.standard_normal(24).astype(np.float32)
        frame["actions"] = np.clip(rng.standard_normal(7), -1, 1).astype(np.float32)
        np.savez(path, **frame)
    return root


def _obs_cfg(root, frame_skip=None, datasets=None, **kw) -> dict:
    from _torch_port_dataset import dm_cfg

    cfg = dm_cfg(root, load_lang_embeddings=True, **kw)
    cfg.update(device_store=False, observation_space=OBS_DATA, frame_skip=frame_skip,
               num_workers=1)
    if datasets is not None:
        cfg["datasets"] = datasets
    return cfg


def _dms(cfg: dict):
    from hulc2_tpu.data.datamodule import Hulc2DataModule as JaxDataModule

    from hulc2_torch.data.datamodule import Hulc2DataModule

    port, jax_dm = Hulc2DataModule(cfg, seed=7, device="cpu"), JaxDataModule(cfg, seed=7)
    port.setup()
    jax_dm.setup()
    return port, jax_dm


def _scene_by_robot(root) -> dict:
    """Every frame's scene_obs, keyed by the bytes of its robot_obs."""
    from pathlib import Path

    out = {}
    for path in Path(root).glob("training/episode_*.npz"):
        with np.load(path) as z:
            out[z["robot_obs"].astype(np.float32).tobytes()] = z["scene_obs"]
    return out


FRAME_SKIPS = {"none": None,
               "random": {"strategy": "random", "effective_min_ws": 5, "effective_max_ws": 8},
               "diff": {"strategy": "diff", "effective_min_ws": 5, "effective_max_ws": 8,
                        "pos_threshold": 0.0, "orn_threshold": 10.0}}


@pytest.mark.parametrize("skip", list(FRAME_SKIPS))
def test_fused_batches_with_depth_and_scene_equal_jax(obs_dir, skip):
    """Two epochs of ``FusedBatchLoader`` against JAX's: every key JAX has
    equal (depth after the cast of the port's stored float16), windows
    skipped to the effective length. The port's batches carry scene_obs,
    which JAX's fused writer drops (``window_dataset.py:133-190``): each
    row's scene_obs is its frame's."""
    port, jax_dm = _dms(_obs_cfg(obs_dir, FRAME_SKIPS[skip]))
    scene = _scene_by_robot(obs_dir)
    loader, jloader = port.fused_train_iter(), jax_dm.fused_train_iter()
    n = 0
    for _ in range(2):
        for got, want in zip(loader, jloader):
            assert "scene_obs" not in want and set(want) <= set(got)
            for k, w in want.items():
                np.testing.assert_array_equal(np.asarray(got[k], w.dtype), w, err_msg=k)
            assert got["depth_static"].dtype == np.float16
            s = 8 if FRAME_SKIPS[skip] else 16
            assert got["actions"].shape[1] == s
            for robot, sc in zip(got["robot_obs_raw"].reshape(-1, 15),
                                 got["scene_obs"].reshape(-1, 24)):
                np.testing.assert_array_equal(sc, scene[robot.tobytes()])
            n += 1
    assert n >= 4


@pytest.mark.parametrize("skip", ["random", "diff"])
def test_skipped_windows_read_only_their_kept_frames(obs_dir, monkeypatch, skip):
    """``write_into`` with frame skipping reads a window's actions, then the
    other keys of its kept frames only: its rows equal the whole window
    loaded and skipped with the same draws, from the disk (one native read
    of rgb_static per kept frame) and from the RAM cache alike."""
    from hulc2_torch.data import episode_index as ei
    from hulc2_torch.data import native_loader
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.data.frame_store import RamFrameStore
    from hulc2_torch.data.window_dataset import WindowDataset

    dm = Hulc2DataModule(_obs_cfg(obs_dir, FRAME_SKIPS[skip]), seed=7, device="cpu")
    dm.setup()
    disk = dm.datasets["vis_training"]
    ram = WindowDataset(disk.index, RamFrameStore(
        disk.store, ei.load_ep_start_end_ids(obs_dir / "training", "training"), disk.store.keys,
        num_workers=1), disk.obs_space, seed=disk.seed, frame_skip=disk.frame_skip)
    read = []
    load = native_loader.load_frames_into
    monkeypatch.setattr(native_loader, "load_frames_into", lambda paths, key, out, **kw: (
        read.append((key, len(paths))), load(paths, key, out, **kw)))
    n, skipped = 6, 0
    for ds in (disk, ram):
        specs = ds.out_specs(n)
        rows = {k: np.zeros(shape, dtype) for k, (shape, dtype) in specs.items()}
        for r in range(n):
            read.clear()
            ds.write_into(r, rows, r, epoch=1)
            reads = list(read)
            rng = np.random.default_rng((ds.seed, 1, r))
            ws = ds.index.window_size(r, rng)
            whole = ds.store.load_window(int(ds.index.episode_lookup[r]), ws)
            ep = disk._apply_skip(whole, rng)
            kept = len(ep["rel_actions"])
            for k, dst in (("rgb_static", "rgb_static"), ("depth_static", "depth_static"),
                           ("scene_obs", "scene_obs"), ("robot_obs", "robot_obs_raw"),
                           ("rel_actions", "actions")):
                np.testing.assert_array_equal(rows[dst][r, :kept], ep[k], err_msg=f"{r} {k}")
            if ds is disk:
                assert ("rgb_static", kept) in reads and ("rel_actions", ws) in reads
            skipped += kept < ws
    assert skipped > 0


@pytest.mark.parametrize("modality", ["vis", "lang"])
def test_single_modality_batches_equal_jax(obs_dir, modality):
    """``datasets=vision_only|lang_only``: the port's training loader yields
    {modality: batch} from the per-modality loader, equal to JAX's
    ``train_iter`` (depth after the cast, scene_obs included: JAX's
    ``__getitem__`` carries it), over two epochs with frame skipping; the
    validation batches too."""
    datasets = {"vis": modality == "vis", "lang": modality == "lang"}
    port, jax_dm = _dms(_obs_cfg(obs_dir, FRAME_SKIPS["random"], datasets))
    assert port.modalities == (modality,) and port.steps_per_epoch() > 0
    loader = port.fused_train_iter()
    n = 0
    for epoch in range(2):
        loader.epoch = epoch
        jax_loader = jax_dm.train_iter()
        for got, want in zip(loader, jax_loader):
            assert set(got) == set(want) == {modality}
            assert set(got[modality]) == set(want[modality]) and "scene_obs" in got[modality]
            for k, w in want[modality].items():
                np.testing.assert_array_equal(np.asarray(got[modality][k], w.dtype), w, err_msg=k)
            n += 1
    assert n >= 2
    for got, want in zip(port.val_iter(), jax_dm.val_iter()):
        assert set(got) == set(want) == {modality}
        for k, w in want[modality].items():
            np.testing.assert_array_equal(np.asarray(got[modality][k], w.dtype), w, err_msg=k)


def test_device_store_carries_depth_and_scene_and_refuses_frame_skip(obs_dir):
    """The device store (on the CPU here) holds the float16 depth rows and
    plans scene_obs with the small keys: its batches equal the host plan's;
    with frame skipping it refuses, as JAX's gather does."""
    from _torch_port_dataset import host_fused_batches

    from hulc2_torch.data.datamodule import Hulc2DataModule

    cfg = {**_obs_cfg(obs_dir), "device_store": True}
    host, dm = Hulc2DataModule(cfg, seed=7, device="cpu"), Hulc2DataModule(cfg, seed=7, device="cpu")
    host.setup()
    dm.setup()
    loader = dm.fused_train_iter()
    assert dm.device_store.arrays["depth_static"].dtype == torch.float16
    for got, want in zip(loader, host_fused_batches(host, 0)):
        assert set(got) == set(want) and "scene_obs" in got
        for k, w in want.items():
            g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
            np.testing.assert_array_equal(g, w, err_msg=k)
    with pytest.raises(NotImplementedError, match="frame_skip"):
        Hulc2DataModule({**cfg, "frame_skip": FRAME_SKIPS["random"]}, device="cpu")
    with pytest.raises(NotImplementedError, match="both modalities"):
        Hulc2DataModule({**cfg, "datasets": {"vis": True, "lang": False}}, device="cpu")


def test_frame_skip_diff_needs_rel_actions(obs_dir):
    from hulc2_torch.data.datamodule import Hulc2DataModule

    cfg = _obs_cfg(obs_dir, FRAME_SKIPS["diff"])
    cfg["observation_space"] = {**OBS_DATA, "actions": ["actions"]}
    with pytest.raises(ValueError, match="rel_actions"):
        Hulc2DataModule(cfg, device="cpu").setup()


# ---- the model options: three train steps --------------------------------- #
EMB_DIM = 384
R1, R2 = 1e-5, 1.0 - 1e-5
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
    "datamodule.max_window_size=4",
]
DEPTH_STATIC = ["model/perceptual_encoder=rgbd_both", "model.perceptual_encoder.depth_gripper=null",
                'datamodule.observation_space.depth_obs=["depth_static"]']
STATIC_ONLY = ["model/perceptual_encoder=static_rgb",
               "datamodule/observation_space=lang_rgb_static_rel_act"]
ROBOT_SCENE = ["model/perceptual_encoder=static_rgb",
               "datamodule/observation_space=lang_rgb_static_robot_scene_abs_act",
               "datamodule/proprioception_dims=robot_scene",
               "model.perceptual_encoder.proprio.n_state_obs=54"]
MODEL_CASES = {
    "depth_static": DEPTH_STATIC,
    "rgbd_both": ["model/perceptual_encoder=rgbd_both",
                  "datamodule/observation_space=lang_rgbd_both_rel_act"],
    "static_proprio": STATIC_ONLY,
    "robot_scene": ROBOT_SCENE,
    "vision_only": ["datamodule/datasets=vision_only"] + DEPTH_STATIC,
    "lang_only": ["datamodule/datasets=lang_only"] + ROBOT_SCENE,
}


def _compose(overrides) -> dict:
    from hulc2_torch.core import config as cfg_lib

    return cfg_lib.compose("cfg_low_level", LOW_SMALL + list(overrides))


def _windows(rng, dm: dict, b: int, lang: bool) -> dict:
    """Raw windows of ``b`` rows with the keys of the config's observation
    space (uint8 frames, float16 depth), and the lang rows' keys."""
    obs, s = dm["observation_space"], dm["max_window_size"]
    sizes = {**tdt.camera_sizes(dm["transforms"]), **tdt.depth_sizes(dm["transforms"])}
    out = {cam: rng.integers(0, 256, (b, s, sizes[cam], sizes[cam], 3), dtype=np.uint8)
           for cam in obs["rgb_obs"]}
    for cam in obs["depth_obs"]:
        out[cam] = rng.uniform(0.5, 2.5, (b, s, sizes[cam], sizes[cam])).astype(np.float16)
    out["robot_obs_raw"] = (rng.standard_normal((b, s, 15)) * 0.3).astype(np.float32)
    if "scene_obs" in obs["state_obs"]:
        out["scene_obs"] = rng.standard_normal((b, s, 24)).astype(np.float32)
    acts = np.clip(rng.standard_normal((b, s, 7)) * 0.3, -1, 1).astype(np.float32)
    acts[..., -1] = np.sign(acts[..., -1] + 1e-6)
    out["actions"] = acts
    if lang:
        out["lang"] = rng.standard_normal((b, EMB_DIM)).astype(np.float32)
        out["use_for_aux_lang_loss"] = np.array([True] + [bool(x) for x in rng.random(b - 1) > 0.5])
    return out


def _raw_batch(rng, cfg: dict, both: bool = False) -> dict:
    """{modality: windows} of the config's modalities (of both with ``both``)."""
    dm = cfg["datamodule"]
    mods = [m for m in ("vis", "lang") if both or (dm.get("datasets") or {}).get(m, True)]
    return {m: _windows(rng, dm, dm[f"batch_size_{m}"], m == "lang") for m in mods}


def _fused(raw: dict) -> dict:
    if len(raw) == 1:
        return next(iter(raw.values()))
    vis, lang = raw["vis"], raw["lang"]
    out = {k: np.concatenate([vis[k], lang[k]]) for k in vis}
    out.update(lang=lang["lang"], use_for_aux_lang_loss=lang["use_for_aux_lang_loss"])
    return out


def _f32(x):
    return jnp.asarray(x.astype(np.float32) if x.dtype == np.float16 else x)


def _jax_tf(cfg: dict, stats, train: bool = True):
    from hulc2_tpu.data.device_transforms import make_batch_transform as jax_transform
    from hulc2_tpu.data.statistics import DatasetStatistics as JStats

    dm = cfg["datamodule"]
    return jax.jit(jax_transform(dm["observation_space"], dm["proprioception_dims"],
                                 JStats(**vars(stats)), dm["transforms"], train=train))


def _jax_model_batch(cfg: dict, raw: dict, stats, key):
    """JAX's model batch of ``raw`` as its train step forms it (fused
    [vis; lang] rows, or one modality's dict) with ``key``'s draws, its
    ``fused_n_vis``, and the port's draws of the same key."""
    dm = cfg["datamodule"]
    pipelines = tdt.TRANSFORM_PRESETS[dm["transforms"]]["train"]
    fused = _fused(raw)
    shapes = {k: (fused[k].shape[0] * fused[k].shape[1], *fused[k].shape[2:4],
                  3 if k.startswith("rgb") else 1)
              for k in dm["observation_space"]["rgb_obs"] + dm["observation_space"]["depth_obs"]}
    draws = jax_draws(key, pipelines, shapes)
    tf = _jax_tf(cfg, stats)
    if len(raw) == 2:
        batch = tf(key, {k: _f32(v) for k, v in fused.items() if k not in ("lang", "use_for_aux_lang_loss")})
        batch["lang"] = jnp.asarray(fused["lang"])
        batch["use_for_aux_lang_loss"] = jnp.asarray(fused["use_for_aux_lang_loss"])
        return batch, raw["vis"]["actions"].shape[0], draws
    (m, w), = raw.items()
    return {m: tf(key, {k: _f32(v) for k, v in w.items()})}, None, draws


def _build_pair(cfg: dict, stats, seed: int = 0):
    """(JAX model, flax params of its init's shapes, the port's
    ``build_policy_for`` model with the same weights). The init sees both
    modalities, so that a single-modality config has the parameters of the
    other modality's goal encoder too (unused, as in the port)."""
    from _torch_port_common import random_flax_params
    from hulc2_tpu.models.build import build_policy as jax_build_policy

    from hulc2_torch.models.build import build_policy_for
    from hulc2_torch.utils.convert import flax_to_torch

    jmodel = jax_build_policy(cfg["model"])
    rng = np.random.default_rng(seed)
    batch, n_vis, _ = _jax_model_batch(cfg, _raw_batch(rng, cfg, both=True), stats,
                                       jax.random.PRNGKey(0))
    keys = {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, 0.01, False, n_vis), keys, batch)
    params = random_flax_params(shapes, seed)
    tmodel = build_policy_for(cfg, seed=0)
    tmodel.load_state_dict(flax_to_torch(params, cfg["model"]), strict=True)
    return jmodel, params, tmodel


def _install_plan_noise(monkeypatch) -> dict:
    from test_torch_port_policy_options import _install_noise

    return _install_noise(monkeypatch)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_three_train_steps_track_jax(monkeypatch, case):
    """Three batches (200/84 px frames, float16 depth, scene_obs where named)
    through the port's train step and JAX's (its transform from a key, the
    port given that key's draws; ``Hulc2.apply`` with the fused or the
    per-modality form; ``optim.make_optimizer``), same weights and plan
    noise: every metric JAX reports, the loss and the gradient norm, rtol
    1e-3."""
    from hulc2_tpu.train import optim as joptim

    from hulc2_torch.train.optim import make_optimizer
    from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step

    holder = _install_plan_noise(monkeypatch)
    cfg = _compose(MODEL_CASES[case])
    rng = np.random.default_rng(20 + len(case))
    stats = _stats(rng)
    jmodel, params, tmodel = _build_pair(cfg, stats, seed=len(case))
    mc, loss_cfg = cfg["model"], cfg["loss"]
    tx = joptim.make_optimizer(mc["optimizer"], mc.get("lr_scheduler"), 20)
    opt_state = tx.init(params)
    betas = {"lang_clip_loss": loss_cfg["clip_auxiliary_loss_beta"],
             **aux_betas_from_loss_cfg(loss_cfg)}

    @functools.partial(jax.jit, static_argnums=5)
    def jstep(params, opt_state, batch, noise, kl_beta, n_vis):
        holder["n"] = noise

        def loss_fn(p):
            m = jmodel.apply(p, batch, kl_beta, False, n_vis,
                             rngs={"sample": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)})
            m["loss"] = m["total_loss"] + sum(b * m[k] for k, b in betas.items() if k in m)
            return m["loss"], m

        (_, m), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        m["grad_norm"] = jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(grads)))
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state, m

    dm = cfg["datamodule"]
    tf = tdt.make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                  dm["transforms"], stats=stats)
    tstep = make_train_step(tmodel, make_optimizer(tmodel.parameters(), mc["optimizer"]), tf,
                            loss_cfg["clip_auxiliary_loss_beta"], aux_betas_from_loss_cfg(loss_cfg),
                            device="cpu")
    for i in range(3):
        raw = _raw_batch(rng, cfg)
        batch, n_vis, draws = _jax_model_batch(cfg, raw, stats, jax.random.PRNGKey(10 + i))
        b = sum(w["actions"].shape[0] for w in raw.values())
        noise = rng.gumbel(size=(b, 4, 5)).astype(np.float32)
        params, opt_state, want = jstep(params, opt_state, batch, jnp.asarray(noise),
                                        loss_cfg["kl_beta"], n_vis)
        traw = {m: {k: torch.from_numpy(v) for k, v in w.items()} for m, w in raw.items()}
        got = tstep(traw, None, loss_cfg["kl_beta"], gumbel=torch.from_numpy(noise), draws=draws)
        assert set(want) - {"loss", "grad_norm"} <= set(got), sorted(set(want) - set(got))
        for name, w in want.items():
            np.testing.assert_allclose(float(got[name]), float(w), rtol=1e-3, atol=1e-5,
                                       err_msg=f"{case} step {i} {name}")


def test_model_widths_follow_the_real_inputs():
    """The widths flax infers: the proprio slice is the processed
    robot_obs's (39 with robot_scene though n_state_obs is 54); the
    decoder's (64, 128) slice is cut to 8 on a 72-wide static-only
    embedding; with depth_static it covers the depth features."""
    from hulc2_torch.models.build import build_policy_for

    scene = build_policy_for(_compose(ROBOT_SCENE))
    assert scene.perceptual_encoder.proprio_dim == 54
    assert scene.visual_goal.mlp[0].in_features == 64 + 39
    assert scene.action_decoder.rnn.weight_ih_l0.shape[1] == 20 + 39 + 8
    static = build_policy_for(_compose(STATIC_ONLY))
    assert static.visual_goal.mlp[0].in_features == 72
    assert static.action_decoder.rnn.weight_ih_l0.shape[1] == 20 + 8 + 8
    depth = build_policy_for(_compose(DEPTH_STATIC))
    pe = depth.perceptual_encoder
    assert pe.depth_static_encoder.conv_model[0].in_channels == 1
    assert pe.rgb_gripper_encoder is not None and pe.depth_gripper_encoder is None
    assert depth.visual_goal.mlp[0].in_features == 192
    # tactile (ported since): its 64 features before the proprio slice
    tactile = build_policy_for(_compose(["model/perceptual_encoder=static_rgb_tactile"]))
    assert tactile.visual_goal.mlp[0].in_features == 64 + 64 + 8


# ---- rollouts ------------------------------------------------------------- #
ROLLOUT_CASES = {"depth_static": DEPTH_STATIC, "static_proprio": STATIC_ONLY}


def _rollout_cfg(case: str) -> dict:
    # the rand_shift_96 preset keeps the renderer's frames small (96/64 px)
    return _compose(ROLLOUT_CASES[case] + ['datamodule.transforms="rand_shift_96"'])


@pytest.mark.parametrize("case", list(ROLLOUT_CASES))
def test_fused_render_policy_step_matches_jax(monkeypatch, case):
    """Render (3 envs; depth_static for the depth policy) -> val transform
    with the split's statistics -> ``policy_step`` -> binarized gripper,
    3 steps with the carry, JAX's samplers given the port's draws: atol 1e-3."""
    from hulc2_tpu.envs.render_jax import make_render_obs_fn as jax_render_fn
    from hulc2_tpu.train.steps import make_fused_render_policy_step as jax_fused
    from test_torch_port_rollout import install_policy_samplers, make_draws, torch_draws

    from hulc2_torch.envs.render_torch import make_render_obs_fn
    from hulc2_torch.train.steps import make_fused_render_policy_step
    from hulc2_torch.tools.profile_eval import perturbed_states

    holder = install_policy_samplers(monkeypatch)
    cfg = _rollout_cfg(case)
    rng = np.random.default_rng(40)
    stats = _stats(rng)
    jmodel, params, tmodel = _build_pair(cfg, stats, seed=41)
    tmodel.eval()
    obs = cfg["datamodule"]["observation_space"]
    rgb, depth = sorted(obs["rgb_obs"]), sorted(obs["depth_obs"])
    with_depth = bool(depth)
    jfn = jax_fused(jmodel, _jax_tf(cfg, stats, train=False),
                    jax_render_fn(96, 64, with_depth=with_depth), rgb, depth)
    dm = cfg["datamodule"]
    ttf = tdt.make_batch_transform(obs, dm["proprioception_dims"], dm["transforms"], train=False,
                                   stats=stats)
    tfn = make_fused_render_policy_step(tmodel, ttf, make_render_obs_fn(96, 64, with_depth=with_depth),
                                        rgb, depth)
    k = 3
    lang = rng.standard_normal((k, EMB_DIM)).astype(np.float32)
    scenes, robots = perturbed_states(3 * k, 42)
    jcarry, tcarry = jmodel.init_carry(k), tmodel.init_carry(k, "cpu")
    for t in range(3):
        state = {"robot_obs": robots[t * k:(t + 1) * k], "scene_obs": scenes[t * k:(t + 1) * k]}
        draws = make_draws(rng, cfg, k)
        holder.update({n: jnp.asarray(v) for n, v in draws.items()})
        with jax.disable_jit():  # the swapped samplers read the draws when traced
            want, jcarry = jfn(params, {n: jnp.asarray(v) for n, v in state.items()},
                               {"lang": jnp.asarray(lang)}, jcarry, jax.random.PRNGKey(0), t)
        got, tcarry = tfn({n: torch.from_numpy(v) for n, v in state.items()},
                          {"lang": torch.from_numpy(lang)}, tcarry, None, torch_draws(draws))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, err_msg=f"step {t}")


# ---- the repaired faults -------------------------------------------------- #
def _host_obs(rng, k: int) -> dict:
    """A farm's stacked host observation at the rand_shift_96 sizes."""
    return {"rgb_obs": {"rgb_static": rng.integers(0, 256, (k, 96, 96, 3), dtype=np.uint8),
                        "rgb_gripper": rng.integers(0, 256, (k, 64, 64, 3), dtype=np.uint8)},
            "depth_obs": {"depth_static": rng.uniform(0.5, 2.5, (k, 96, 96)).astype(np.float32)},
            "robot_obs": (rng.standard_normal((k, 15)) * 0.3).astype(np.float32),
            "scene_obs": rng.standard_normal((k, 24)).astype(np.float32)}


def test_eval_agent_normalises_proprio_with_the_training_statistics(monkeypatch):
    """Repair 1. A static-only proprio policy's rollout through the port's
    ``Hulc2Agent`` given the training split's statistics equals JAX's agent
    constructed with the same ``stats`` (atol 1e-3, 4 steps); JAX's eval
    gives its agent none (``evaluate_policy.py:339``), and without them the
    actions differ."""
    from hulc2_tpu.agents.hulc2_agent import Hulc2Agent as JaxAgent
    from hulc2_tpu.data.statistics import DatasetStatistics as JStats
    from test_torch_port_rollout import install_policy_samplers, make_draws, torch_draws

    from hulc2_torch.agents.hulc2_agent import Hulc2Agent

    holder = install_policy_samplers(monkeypatch)
    cfg = _rollout_cfg("static_proprio")
    rng = np.random.default_rng(50)
    stats = _stats(rng)
    jmodel, params, tmodel = _build_pair(cfg, stats, seed=51)
    tmodel.eval()
    k = 3
    jagent = JaxAgent(None, jmodel, params, cfg["datamodule"], stats=JStats(**vars(stats)), n_envs=k)
    agents = {"stats": Hulc2Agent(tmodel, cfg["datamodule"], n_envs=k, stats=stats),
              "none": Hulc2Agent(tmodel, cfg["datamodule"], n_envs=k)}
    goal = {"lang": rng.standard_normal((k, EMB_DIM)).astype(np.float32)}
    differ = 0.0
    for t in range(4):
        obs, draws = _host_obs(rng, k), make_draws(rng, cfg, k)
        holder.update({n: jnp.asarray(v) for n, v in draws.items()})
        with jax.disable_jit():
            want = np.asarray(jagent.step(obs, goal))
        got = {name: a.step_async(obs, goal, torch_draws(draws)).numpy() for name, a in agents.items()}
        np.testing.assert_allclose(got["stats"], want, atol=1e-3, err_msg=f"step {t}")
        differ = max(differ, float(np.abs(got["none"] - want).max()))
    assert differ > 1e-2


def test_run_statistics_come_from_the_run_dir(tmp_path):
    """Repair 1's source: the eval reads a run's statistics from the
    ``statistics.json`` the trainer writes into it. A run dir without it
    raises for a policy that reads normalised state (a proprio encoder, or
    scene_obs in its observation space) and gives None for one that reads
    none; a dataset's statistics.yaml is not read in its place."""
    from hulc2_torch.data.statistics import save_statistics
    from hulc2_torch.evaluation.loading import run_statistics

    (tmp_path / "training").mkdir()
    (tmp_path / "training" / "statistics.yaml").write_text("robot_obs: []\n")
    scene = _compose(ROBOT_SCENE)
    scene_only = {**scene, "model": {**scene["model"], "perceptual_encoder": {
        **scene["model"]["perceptual_encoder"], "proprio": None}}}
    proprio, plain = _compose(STATIC_ONLY), _compose([])
    for cfg in (proprio, scene, scene_only, plain):
        cfg["datamodule"]["root_data_dir"] = str(tmp_path)
    for cfg in (proprio, scene, scene_only):
        with pytest.raises(FileNotFoundError, match="statistics.json"):
            run_statistics(tmp_path, cfg)
    assert run_statistics(tmp_path, plain) is None
    stats = _stats(np.random.default_rng(70))
    save_statistics(tmp_path, stats)
    got = run_statistics(tmp_path, scene)
    for k in ("robot_obs_mean", "robot_obs_std", "scene_obs_mean", "scene_obs_std"):
        np.testing.assert_array_equal(getattr(got, k), getattr(stats, k), err_msg=k)


def test_scene_obs_reaches_every_path_where_jax_drops_it():
    """Repair 2. For an observation space naming scene_obs (robot_scene),
    JAX's agent leaves scene_obs out of its raw batch (``_obs_to_device``,
    ``hulc2_agent.py:146-164``) and its fused render step hands its
    transform none (``steps.py:196-201``), so the policy would see robot_obs
    15 wide where it trained on 39 (its fused loader drops it too, see
    ``test_fused_batches_with_depth_and_scene_equal_jax``). The port's keep
    it, and the transform refuses a batch without it."""
    from hulc2_tpu.agents.hulc2_agent import Hulc2Agent as JaxAgent
    from hulc2_tpu.envs.render_jax import make_render_obs_fn as jax_render_fn
    from hulc2_tpu.train.steps import make_fused_render_policy_step as jax_fused

    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.envs.render_torch import make_render_obs_fn
    from hulc2_torch.models.build import build_policy_for
    from hulc2_torch.train.steps import make_fused_render_policy_step

    cfg = _compose(ROBOT_SCENE + ['datamodule.transforms="rand_shift_96"'])
    dm = cfg["datamodule"]
    rng = np.random.default_rng(60)
    stats = _stats(rng)
    obs = _host_obs(rng, 2)
    jtf = _jax_tf(cfg, stats, train=False)
    stub = types.SimpleNamespace(init_carry=lambda n: None)  # _obs_to_device reads no model
    jagent = JaxAgent(None, stub, None, dm, n_envs=2, fused_step=lambda *a: None)
    jraw = jagent._obs_to_device(obs)
    assert "scene_obs" not in jraw
    assert jtf(jax.random.PRNGKey(0), jraw)["robot_obs"].shape[-1] == 15

    tmodel = build_policy_for(cfg).eval()
    agent = Hulc2Agent(tmodel, dm, n_envs=2, stats=stats)
    traw = agent._obs_to_device(obs)
    np.testing.assert_array_equal(traw["scene_obs"][:, 0].numpy(), obs["scene_obs"])
    assert agent._transform(traw, None)["robot_obs"].shape[-1] == 39

    class Seen(Exception):
        pass

    def recording(seen, raw_arg: int):
        """A transform that records its raw batch's keys and stops the step
        (JAX's takes (rng, raw), the port's (raw, generator))."""
        def transform(*args):
            seen.update(args[raw_arg])
            raise Seen

        return transform

    state = {"robot_obs": obs["robot_obs"], "scene_obs": obs["scene_obs"]}
    jseen, tseen = {}, {}
    with pytest.raises(Seen), jax.disable_jit():
        jax_fused(None, recording(jseen, 1), jax_render_fn(96, 64, with_depth=False), ["rgb_static"],
                  [])(None, {n: jnp.asarray(v) for n, v in state.items()}, {}, None,
                      jax.random.PRNGKey(0), 0)
    assert "scene_obs" not in jseen
    with pytest.raises(Seen):
        make_render_policy = make_fused_render_policy_step(
            tmodel, recording(tseen, 0), make_render_obs_fn(96, 64, with_depth=False), ["rgb_static"])
        make_render_policy({n: torch.from_numpy(v) for n, v in state.items()}, {}, None, None)
    np.testing.assert_array_equal(tseen["scene_obs"][:, 0].numpy(), obs["scene_obs"])
    with pytest.raises(KeyError, match="scene_obs"):
        agent._transform({k: v for k, v in traw.items() if k != "scene_obs"}, None)


# ---- the entry points on the CPU ------------------------------------------ #
@pytest.fixture(scope="module")
def low_obs_dir(tmp_path_factory):
    """``write_low_level_dir``'s dataset at 200/84 px (384-d embeddings,
    goal tables) with float16 depth_static, scene_obs and absolute actions
    in every frame, the keys the port's generator writes."""
    from pathlib import Path

    from test_torch_port_host_loader import write_low_level_dir

    root = write_low_level_dir(tmp_path_factory.mktemp("low_obs"))
    rng = np.random.default_rng(6)
    for path in sorted(Path(root).glob("*/episode_*.npz")):
        with np.load(path) as z:
            frame = dict(z)
        frame["depth_static"] = rng.uniform(0.5, 2.5, (200, 200)).astype(np.float16)
        frame["scene_obs"] = (rng.standard_normal(24) * 0.1).astype(np.float32)
        frame["actions"] = np.clip(rng.standard_normal(7) * 0.3, -1, 1).astype(np.float32)
        np.savez(path, **frame)
    return root


# frame skipping cut to LOW_TINY's windows of 3-4 frames (the transformer's
# positions end at max_window_size)
SKIP_TINY = ["datamodule.frame_skip.effective_min_ws=2", "datamodule.frame_skip.effective_max_ws=3"]
CLI_CASES = {
    "depth_static": (DEPTH_STATIC, True),
    "static_scene_frame_skip": (ROBOT_SCENE + ["datamodule/frame_skip=random"] + SKIP_TINY, True),
    "vision_only": (["datamodule/datasets=vision_only"], False),
    "lang_only": (["datamodule/datasets=lang_only", "datamodule/frame_skip=diff"] + SKIP_TINY,
                  False),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_training_and_eval_entry_points_on_cpu(tmp_path, monkeypatch, low_obs_dir, case):
    """``python -m hulc2_torch.training --config-name cfg_low_level`` with the
    option at tiny width trains 2 steps and a val batch from the dataset and
    writes the training statistics into the run; ``evaluate_policy
    --device-render`` scores the depth and the static-only/scene runs, its
    agents holding those statistics."""
    from test_torch_port_host_loader import LOW_TINY

    from hulc2_torch import training
    from hulc2_torch.agents import hulc2_agent
    from hulc2_torch.data.statistics import load_run_statistics, load_statistics
    from hulc2_torch.evaluation import evaluate_policy

    overrides, evaluate = CLI_CASES[case]
    monkeypatch.setenv("HULC2_SEQUENCES_CACHE_DIR", str(tmp_path))
    run = tmp_path / "run"
    result = training.main(["--config-name", "cfg_low_level", "--run-dir", str(run), "--device",
                            "cpu", "--max-epochs", "1", f"datamodule.root_data_dir={low_obs_dir}",
                            *LOW_TINY, *overrides])
    assert result.step == 2 and len(result.val_history) == 1
    assert all(np.isfinite(v) for line in result.history + result.val_history for v in line.values())
    want = load_statistics(low_obs_dir / "training")
    np.testing.assert_array_equal(load_run_statistics(run).robot_obs_std, want.robot_obs_std)
    modalities = {k[len("train/action_loss_"):] for k in result.history[0]
                  if k.startswith("train/action_loss_")}
    assert modalities == {"vision_only": {"vis"}, "lang_only": {"lang"}}.get(case, {"vis", "lang"})
    if not evaluate:
        return
    seen = []
    init = hulc2_agent.Hulc2Agent.__init__

    def recording(self, *args, **kw):
        seen.append(kw.get("stats"))
        init(self, *args, **kw)

    monkeypatch.setattr(hulc2_agent.Hulc2Agent, "__init__", recording)
    merged = evaluate_policy.main(["--train-dir", str(run), "--dataset-path", str(low_obs_dir),
                                   "--fake-env", "--device-render", "--n-envs", "2", "--cohorts",
                                   "1", "--num-sequences", "2", "--ep-len", "2", "--device", "cpu"])
    assert 0.0 <= merged["latest"]["avg_seq_len"] <= 5.0
    assert len(seen) == 1 and np.array_equal(seen[0].robot_obs_mean, want.robot_obs_mean)


def test_native_reads_of_depth_and_scene_equal_np_load(obs_dir):
    """The native loader lands float16 depth_static and scene_obs entries in
    their rows as stored, byte for byte as ``np.load`` reads them."""
    from hulc2_torch.data.frame_store import NpzFrameStore

    store = NpzFrameStore(obs_dir / "training", ["depth_static", "scene_obs", "robot_obs"])
    for start, size in ((0, 1), (17, 9), (100, 16)):
        got, want = store.load_window(start, size), store.load_window_plain(start, size)
        assert got["depth_static"].dtype == np.float16
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# the observation-space presets whose keys the port's datasets have, each
# with the perceptual encoder its cameras need
PRESET_MODELS = {
    "lang_rgb_static_abs_act": ["model/perceptual_encoder=static_rgb"],
    "lang_rgb_static_rel_act": ["model/perceptual_encoder=static_rgb"],
    "lang_rgb_static_gripper_abs_act": [],
    "lang_rgb_static_gripper_rel_act": [],
    "lang_rgb_static_robot_scene_abs_act": ["model/perceptual_encoder=static_rgb"],
    "lang_rgbd_static_robot_abs_act": ["model/perceptual_encoder=rgbd_both",
                                       "model.perceptual_encoder.rgb_gripper=null",
                                       "model.perceptual_encoder.depth_gripper=null"],
    "rgb_static_abs_act": ["model/perceptual_encoder=static_rgb"],
    "rgb_static_robot_scene_abs_act": ["model/perceptual_encoder=static_rgb"],
}
PROPRIO_PRESETS = ["none", "robot_full", "robot_no_joints", "robot_no_joints_no_gripper_width",
                   "robot_scene"]


def _one_train_step(root, overrides) -> dict:
    """One CPU train step of the tiny ``cfg_low_level`` with ``overrides`` on
    a batch of its own training loader from the 16 px dataset (resized to
    the preset's 200/84 px by the transform)."""
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.models.build import build_policy_for
    from hulc2_torch.train.optim import make_optimizer
    from hulc2_torch.train.steps import make_train_step

    cfg = _compose([f"datamodule.root_data_dir={root}", "datamodule.num_workers=1",
                    "datamodule.min_window_size=3", "model.language_goal.in_features=32"]
                   + overrides)  # the dataset's embeddings are 32 wide
    dm = Hulc2DataModule(cfg["datamodule"], seed=0, device="cpu")
    dm.setup()
    batch = next(iter(dm.fused_train_iter()))
    raw = ({k: torch.from_numpy(v) for k, v in batch.items()} if "actions" in batch else
           {m: {k: torch.from_numpy(v) for k, v in b.items()} for m, b in batch.items()})
    model = build_policy_for(cfg)
    d = cfg["datamodule"]
    tf = tdt.make_batch_transform(d["observation_space"], d["proprioception_dims"], d["transforms"],
                                  stats=dm.stats["training"])
    step = make_train_step(model, make_optimizer(model.parameters(), cfg["model"]["optimizer"]), tf,
                           device="cpu")
    metrics = step(raw, torch.Generator().manual_seed(0), 0.01)
    return {"metrics": metrics, "model": model, "robot_obs": tf(
        raw if "actions" in raw else next(iter(raw.values())), torch.Generator().manual_seed(0))
        ["robot_obs"]}


@pytest.mark.parametrize("preset", list(PRESET_MODELS))
def test_every_observation_space_preset_trains(obs_dir, preset):
    """A train step from disk under each preset the dataset's keys allow:
    finite losses, the model's embedding as wide as its encoders say."""
    out = _one_train_step(obs_dir, [f"datamodule/observation_space={preset}"]
                          + PRESET_MODELS[preset])
    assert all(torch.isfinite(v).all() for v in out["metrics"].values())
    pe = out["model"].perceptual_encoder
    assert (pe.rgb_gripper_encoder is not None) == ("gripper" in preset)
    assert (pe.depth_static_encoder is not None) == ("rgbd" in preset)


@pytest.mark.parametrize("dims", PROPRIO_PRESETS)
def test_every_proprioception_preset_trains(obs_dir, dims):
    """Each ``datamodule/proprioception_dims`` preset under the static-only
    policy with the proprio encoder (robot_scene with scene_obs): the
    processed robot_obs has the preset's width and the encoder's slice is
    cut to it."""
    overrides = ["model/perceptual_encoder=static_rgb", f"datamodule/proprioception_dims={dims}"]
    if dims == "robot_scene":
        overrides.append("datamodule/observation_space=lang_rgb_static_robot_scene_abs_act")
    out = _one_train_step(obs_dir, overrides)
    assert all(torch.isfinite(v).all() for v in out["metrics"].values())
    width = {"none": 0, "robot_full": 15, "robot_no_joints": 8,
             "robot_no_joints_no_gripper_width": 7, "robot_scene": 39}[dims]
    assert out["robot_obs"].shape[-1] == width
    assert out["model"].visual_goal.mlp[0].in_features == 64 + min(8, width)


def test_unported_observation_spaces_are_refused_by_name():
    # tactile cameras, once refused here, are ported: 6-channel frames through
    # the preset's tactile pipeline (held to JAX in test_torch_port_pretrained_rw.py)
    tf = tdt.make_batch_transform({**OBS_SPACE, "rgb_obs": ["rgb_static", "rgb_tactile"],
                                   "depth_obs": []}, ROBOT_SCENE_DIMS, "rand_shift", train=False)
    rng = np.random.default_rng(0)
    raw = {"rgb_static": torch.from_numpy(rng.integers(0, 256, (1, 2, 200, 200, 3), dtype=np.uint8)),
           "rgb_tactile": torch.from_numpy(rng.integers(0, 256, (1, 2, 80, 72, 6), dtype=np.uint8)),
           "robot_obs_raw": torch.zeros(1, 2, 15), "scene_obs": torch.zeros(1, 2, 24),
           "actions": torch.zeros(1, 2, 7)}
    out = tf(raw, torch.Generator().manual_seed(0))
    assert out["rgb_obs"]["rgb_tactile"].shape == (1, 2, 64, 64, 6)
    with pytest.raises(NotImplementedError, match="state_only"):
        tdt.make_batch_transform({**OBS_SPACE, "rgb_obs": []}, ROBOT_SCENE_DIMS, "rand_shift")


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("strategy", ["random", "diff"])
def test_frame_skip_windows_fit_the_posterior(package, strategy):
    """Frame skipping pads windows to ``effective_max_ws``; the posterior's
    positions end at ``max_position_embeddings`` (``${datamodule.max_window_size}``).
    Both registries' presets keep the padded window within the table (16 of
    32), and a window one frame longer than the table is refused by both
    packages' posteriors at the first forward, never silently truncated."""
    if package == "jax":
        from hulc2_tpu.core import config as reg
        from hulc2_tpu.models.distributions import PlanDistribution
        from hulc2_tpu.models.plan_nets import PlanRecognitionTransformer as JPost
    else:
        from hulc2_torch.core import config as reg
        from hulc2_torch.models.plan_nets import PlanRecognitionTransformer
    cfg = reg.compose("cfg_low_level", [f"datamodule/frame_skip={strategy}"])
    max_pos = cfg["model"]["plan_recognition"]["max_position_embeddings"]
    assert cfg["datamodule"]["frame_skip"]["effective_max_ws"] <= max_pos == 32
    x = np.zeros((1, 9, 16), np.float32)
    if package == "jax":
        post = JPost(PlanDistribution("discrete", 4, 5), num_heads=2, num_layers=1,
                     encoder_hidden_size=16, fc_hidden_size=16, max_position_embeddings=8)
        with pytest.raises((TypeError, ValueError)):
            post.init(jax.random.PRNGKey(0), jnp.asarray(x))
    else:
        post = PlanRecognitionTransformer(16, 40, num_heads=2, num_layers=1,
                                          encoder_hidden_size=16, fc_hidden_size=16,
                                          max_position_embeddings=8)
        post(torch.from_numpy(x[:, :8]))
        with pytest.raises(RuntimeError):
            post(torch.from_numpy(x))
