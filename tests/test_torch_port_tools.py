"""The port's dataset, annotation and image tools against the JAX package's.

Each tool runs on both packages with the same seeded numpy inputs in
``tmp_path``: the files they write must be equal byte for byte (statistics
to 1e-12), the images pixel for pixel, the rotations to 1e-6. Also: the
launcher's sbatch text and watchdog, the fake env's ``perform`` and the
faults of this slice that were looked for (the affordance preview's
marker, the flat-directory split, the token detector's preview).
"""
import json
import os
import shutil
import sqlite3
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hulc2_tpu.envs.fake_env as jax_fake_env
import hulc2_tpu.evaluation.sequences as jax_sequences
import hulc2_tpu.ops.rotations as jax_rot
import hulc2_tpu.tools.annotation_db as jax_adb
import hulc2_tpu.tools.auto_lang_annotator as jax_ann
import hulc2_tpu.tools.dataset_tools as jax_dt
import hulc2_tpu.tools.launch as jax_launch
import hulc2_tpu.tools.make_seq_videos as jax_msv
import hulc2_tpu.tools.make_synthetic_dataset as jax_syn
import hulc2_tpu.tools.preprocess_real_data as jax_prep
import hulc2_tpu.tools.split_dataset as jax_split
import hulc2_tpu.tools.visualize_dataset as jax_viz
import hulc2_tpu.utils.flowlib as jax_flow
import hulc2_tpu.utils.img_utils as jax_img
from hulc2_torch.data import statistics as port_stats
from hulc2_torch.data.episode_index import load_ep_start_end_ids
from hulc2_torch.envs import fake_env
from hulc2_torch.evaluation import sequences
from hulc2_torch.ops import rotations
from hulc2_torch.tools import (annotation_db, auto_lang_annotator, dataset_tools, launch,
                               make_seq_videos, make_synthetic_dataset, preprocess_real_data,
                               split_dataset, visualize_dataset)
from hulc2_torch.utils import flowlib, img_utils

REPO = Path(__file__).resolve().parents[1]


def same_tree(a: Path, b: Path) -> None:
    """The two directories hold the same files with the same bytes."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for p in fa:
        assert (a / p).read_bytes() == (b / p).read_bytes(), p


def write_play(root: Path, ranges, seed: int = 0, task_at: dict = None, hw: int = 0) -> Path:
    """Per-frame npz play data with ``ep_start_end_ids.npy``; ``task_at``
    {frame: scene index} opens the drawer there, so the oracle sees a task;
    ``hw`` > 0 adds rgb frames."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    np.save(root / "ep_start_end_ids.npy", np.asarray(ranges))
    for start, end in ranges:
        scene = np.zeros(24)
        for i in range(start, end + 1):
            if task_at and i in task_at:
                scene = scene.copy()
                scene[1] = 0.22
            frame = dict(robot_obs=rng.standard_normal(15).astype(np.float32),
                         scene_obs=scene.astype(np.float32),
                         actions=rng.uniform(-0.4, 0.4, 7).astype(np.float32),
                         rel_actions=rng.uniform(-1, 1, 7).astype(np.float32))
            if hw:
                frame["rgb_static"] = rng.integers(0, 256, (hw, hw, 3), np.uint8)
                frame["rgb_gripper"] = rng.integers(0, 256, (hw // 2, hw // 2, 3), np.uint8)
            np.savez(root / f"episode_{i:07d}.npz", **frame)
    return root


def twin(tmp_path: Path, make) -> tuple:
    """The same input written twice: (JAX's copy, the port's copy)."""
    a, b = tmp_path / "jax", tmp_path / "port"
    make(a)
    shutil.copytree(a, b)
    return a, b


# --------------------------------------------------------------------- images
@pytest.mark.parametrize("case", ["caption_bottom", "caption_top", "blend", "heatmap",
                                  "marker", "unnormalize", "resize_pixel"])
def test_img_utils_pixel_equal(case):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), np.uint8)
    if case == "caption_bottom":
        pair = [m.add_img_text(img, "open the drawer") for m in (jax_img, img_utils)]
    elif case == "caption_top":
        pair = [m.add_img_text(img[:20], "gt label", bottom=False) for m in (jax_img, img_utils)]
    elif case == "blend":
        other = rng.integers(0, 256, img.shape, np.uint8)
        pair = [m.blend_imgs(img, other, 0.3) for m in (jax_img, img_utils)]
    elif case == "heatmap":
        heat = rng.random((12, 16)).astype(np.float32)
        pair = [m.heatmap_overlay(img, heat, 0.5) for m in (jax_img, img_utils)]
    elif case == "marker":
        pair = [m.draw_marker(img, (20, 30)) for m in (jax_img, img_utils)]
    elif case == "unnormalize":
        t = rng.standard_normal((8, 8, 3)).astype(np.float32)
        pair = [m.unnormalize_image(t) for m in (jax_img, img_utils)]
    else:
        px = rng.integers(0, 200, (5, 2))
        pair = [m.resize_pixel(px, (200, 200), (64, 84)) for m in (jax_img, img_utils)]
    assert pair[0].dtype == pair[1].dtype
    np.testing.assert_array_equal(pair[0], pair[1])


@pytest.mark.parametrize("max_rad", [None, 0.5])
def test_flowlib_pixel_equal(max_rad):
    np.testing.assert_array_equal(jax_flow.make_color_wheel(), flowlib.make_color_wheel())
    flow = np.random.default_rng(1).standard_normal((20, 24, 2)).astype(np.float32)
    np.testing.assert_array_equal(jax_flow.flow_to_color(flow, max_rad),
                                  flowlib.flow_to_color(flow, max_rad))


# ----------------------------------------------------------------- rotations
def test_quaternions_match_jax():
    rng = np.random.default_rng(2)
    euler = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    # rotations by nearly pi about x, y and z: the x-, y- and z-dominant branches
    euler[:3] = [[3.1, 0.0, 0.0], [0.0, 1.55, 3.1], [0.0, 0.0, 3.1]]
    mats = np.asarray(jax_rot.euler_angles_to_matrix(jnp.asarray(euler)))
    want = np.asarray(jax_rot.matrix_to_quaternion(jnp.asarray(mats)))
    got = rotations.matrix_to_quaternion(torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(rotations.quaternion_to_matrix(torch.from_numpy(q)).numpy(),
                               np.asarray(jax_rot.quaternion_to_matrix(jnp.asarray(q))),
                               atol=1e-6)
    np.testing.assert_allclose(
        rotations.quaternion_to_matrix(rotations.matrix_to_quaternion(torch.from_numpy(mats))),
        mats, atol=1e-5)


def test_exhaustive_sequences_match_jax():
    state = sequences.enumerate_initial_states()[5]
    got = sequences.exhaustive_sequences_for_state(state)
    assert got == jax_sequences.exhaustive_sequences_for_state(state)
    assert len(got) > 10 and sequences.exhaustive_sequences_for_state(state, 7) == got[:7]


def test_fake_env_perform_matches_jax():
    """``perform`` on both fake envs: every feasible task of a seeded walk
    leaves the same scene."""
    from hulc2_torch.envs.task_oracle import symbolic_state_from_scene
    from hulc2_torch.evaluation.initial_states import get_env_state_for_initial_condition
    from hulc2_torch.evaluation.tasks import TASK_NAMES, successor_states

    rng = np.random.default_rng(3)
    envs = [jax_fake_env.FakeCalvinEnv(8, 8), fake_env.FakeCalvinEnv(8, 8)]
    robot, scene = get_env_state_for_initial_condition(sequences.enumerate_initial_states()[0])
    for env in envs:
        env.reset(robot_obs=robot, scene_obs=scene)
    done = set()
    for _ in range(40):
        sym = symbolic_state_from_scene(envs[1].scene_obs, held=envs[1]._held)
        feasible = [t for t in TASK_NAMES if len(successor_states(sym, t)) == 1]
        task = feasible[int(rng.integers(len(feasible)))]
        for env in envs:
            env.perform(task)
        done.add(task)
        np.testing.assert_array_equal(envs[0].scene_obs, envs[1].scene_obs)
        assert envs[0]._held == envs[1]._held
    assert len(done) > 8
    with pytest.raises(RuntimeError, match="no block is held"):
        fake_env.FakeCalvinEnv(8, 8).perform("place_in_drawer")


# ------------------------------------------------------------ dataset tools
@pytest.mark.parametrize("strategy,ranges", [("best", [(0, 40), (41, 70), (71, 130), (131, 150)]),
                                             ("per_episode", [(0, 60), (61, 99)]),
                                             ("best", [(0, 80)])])
def test_split_dataset_matches_jax(tmp_path, strategy, ranges):
    a, b = twin(tmp_path, lambda d: write_play(d, ranges))
    want = jax_split.split_dataset(a, 0.2, 3, strategy)
    assert split_dataset.split_dataset(b, 0.2, 3, strategy) == want
    assert (a / "split.json").read_bytes() == (b / "split.json").read_bytes()
    # PyYAML's text, byte for byte, and the values to 1e-12
    assert (a / "statistics.yaml").read_text() == (b / "statistics.yaml").read_text()
    import yaml

    sa, sb = (yaml.safe_load((d / "statistics.yaml").read_text()) for d in (a, b))
    for key in ("act_min_bound", "act_max_bound"):
        np.testing.assert_allclose(sb[key], sa[key], rtol=0, atol=1e-12)
    for key in ("mean", "std"):
        np.testing.assert_allclose(sb["robot_obs"][0][key], sa["robot_obs"][0][key], rtol=0,
                                   atol=1e-12)


def test_statistics_written_by_split_dataset_load(tmp_path):
    """The port's reader takes back what ``split_dataset`` computed."""
    write_play(tmp_path, [(0, 30), (31, 50)])
    split = split_dataset.split_dataset(tmp_path)
    stats = split_dataset.compute_statistics(tmp_path, split["training"])
    got = port_stats.load_statistics(tmp_path)
    np.testing.assert_array_equal(got.robot_obs_mean,
                                  np.asarray(stats["robot_obs"][0]["mean"], np.float32))
    np.testing.assert_array_equal(got.robot_obs_std,
                                  np.asarray(stats["robot_obs"][0]["std"], np.float32))
    assert got.act_min_bound == stats["act_min_bound"] and len(got.act_max_bound) == 7


def test_flat_split_is_not_read_by_either_datamodule(tmp_path):
    """A flat directory ``split_dataset`` wrote keeps its
    ``ep_start_end_ids.npy``, which both packages' episode readers take before
    ``split.json``: its validation episodes would train (ROADMAP C). Without
    the ranges file, both read the split."""
    from hulc2_tpu.data.episode_index import load_ep_start_end_ids as jax_load

    write_play(tmp_path, [(0, 40), (41, 70), (71, 90)])
    split = split_dataset.split_dataset(tmp_path, 0.2)
    for load in (jax_load, load_ep_start_end_ids):
        assert load(tmp_path, "validation").tolist() == [[0, 40], [41, 70], [71, 90]]
    (tmp_path / "ep_start_end_ids.npy").unlink()
    for load in (jax_load, load_ep_start_end_ids):
        assert load(tmp_path, "validation").tolist() == split["validation"]


def test_combine_and_proprio_stats_match_jax(tmp_path):
    srcs = [write_play(tmp_path / "a", [(0, 20), (21, 30)], 1),
            write_play(tmp_path / "b", [(5, 25)], 2)]
    want = jax_dt.combine_datasets(srcs, tmp_path / "jax")
    got = dataset_tools.combine_datasets(srcs, tmp_path / "port")
    np.testing.assert_array_equal(got, want)
    same_tree(tmp_path / "jax", tmp_path / "port")
    assert dataset_tools.compute_proprioception_statistics(tmp_path / "port") == \
        jax_dt.compute_proprioception_statistics(tmp_path / "jax")
    same_tree(tmp_path / "jax", tmp_path / "port")


def _aff_tree(root: Path) -> None:
    (root / "training").mkdir(parents=True)
    np.save(root / "training" / "ep_start_end_ids.npy", np.array([[0, 99], [100, 199]]))
    split = {"training": {"episode_0": {"static_cam": [f"frame_{i:07d}" for i in range(0, 200, 7)],
                                        "gripper_cam": []}, "note": "x"},
             "validation": {"episode_1": {"static_cam": ["frame_0000200"], "gripper_cam": []}}}
    (root / "episodes_split.json").write_text(json.dumps(split))


def test_percentage_splits_and_old_format_match_jax(tmp_path):
    a, b = twin(tmp_path, _aff_tree)
    assert [p.name for p in dataset_tools.create_percentage_splits(b, (0.5, 0.25))] == \
        [p.name for p in jax_dt.create_percentage_splits(a, (0.5, 0.25))]
    old = {"training": {"ep_0": ["static_cam/frame_1", "gripper_cam/frame_2"]},
           "validation": {"ep_1": ["static_cam/frame_3"]}}
    for d in (a, b):
        (d / "episodes_split.json").write_text(json.dumps(old))
    jax_dt.transform_old_episodes_split(a)
    dataset_tools.transform_old_episodes_split(b)
    same_tree(a, b)


@pytest.mark.parametrize("last_k,seed", [(1, None), (0, 3)])
def test_split_raw_real_matches_jax(tmp_path, last_k, seed):
    def raw(root):
        root.mkdir()
        ids = [[5 * e, 5 * e + 4] for e in range(12)]
        for i in range(60):
            np.savez(root / f"frame_{i:07d}.npz", x=np.full(2, i))
        np.savez(root / "camera_info.npz", k=np.eye(3))
        np.save(root / "ep_start_end_ids.npy", np.array(ids))

    a, b = twin(tmp_path, raw)
    want = jax_dt.split_raw_real_dataset(a, last_k, seed)
    got = dataset_tools.split_raw_real_dataset(b, last_k, seed)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    same_tree(a, b)


def test_dataset_tools_cli(tmp_path):
    src = write_play(tmp_path / "src", [(0, 10)])
    dataset_tools.main(["combine", str(src), "--out-dir", str(tmp_path / "port")])
    jax_dt.main(["combine", str(src), "--out-dir", str(tmp_path / "jax")])
    dataset_tools.main(["proprio-stats", str(tmp_path / "port")])
    jax_dt.main(["proprio-stats", str(tmp_path / "jax")])
    same_tree(tmp_path / "jax", tmp_path / "port")


def test_synthetic_dataset_matches_jax_byte_for_byte(tmp_path):
    kw = dict(episodes=2, frames_per_episode=70, val_episodes=1, val_frames=40, static_hw=16,
              gripper_hw=8, n_lang=6, lang_dim=12, seed=4)
    jax_syn.make_synthetic_calvin(tmp_path / "jax", **kw)
    make_synthetic_dataset.make_synthetic_calvin(tmp_path / "port", **kw)
    same_tree(tmp_path / "jax", tmp_path / "port")
    ann = np.load(tmp_path / "port" / "training" / "lang_annotations" / "auto_lang_ann.npy",
                  allow_pickle=True).item()
    assert len(ann["language"]["ann"]) == 6 and ann["language"]["emb"].shape == (6, 1, 12)
    # the CLI's defaults and argument order are JAX's
    make_synthetic_dataset.main([str(tmp_path / "cli"), "--episodes", "1", "--frames", "30",
                                 "--val-frames", "20", "--static-hw", "8", "--gripper-hw", "8"])
    jax_syn.main([str(tmp_path / "cli_jax"), "--episodes", "1", "--frames", "30",
                  "--val-frames", "20", "--static-hw", "8", "--gripper-hw", "8"])
    same_tree(tmp_path / "cli_jax", tmp_path / "cli")


# ------------------------------------------------------------ real robot data
def _raw_frame(rng, t, quat=True):
    orn = np.array([0.0, 0.0, np.sin(0.05 * t), np.cos(0.05 * t)]) if quat else \
        rng.uniform(-3, 3, 3)
    return {"robot_state": {"tcp_pos": np.array([0.4 + 0.001 * t, 0.01 * t, 0.5]),
                            "tcp_orn": orn, "gripper_opening_width": 0.07,
                            "joint_positions": rng.standard_normal(7)},
            "action": {"motion": np.array([0, 0, 0, 1.0 if t % 3 else -1.0])},
            "rgb_static": rng.integers(0, 255, (8, 8, 3), np.uint8)}


@pytest.mark.parametrize("low_freq,quat", [(0, True), (2, True), (0, False)])
def test_preprocess_recording_matches_jax(tmp_path, low_freq, quat):
    rng = np.random.default_rng(5)
    recs = []
    for r in range(2):
        rec = tmp_path / f"rec{r}"
        rec.mkdir()
        for t in range(7):
            np.savez(rec / f"frame_{t:04d}.npz", **_raw_frame(rng, t, quat))
        recs.append(str(rec))
    extra = ["--low-freq-factor", str(low_freq)] if low_freq else []
    jax_prep.main([*recs, "--out-dir", str(tmp_path / "jax"), *extra])
    preprocess_real_data.main([*recs, "--out-dir", str(tmp_path / "port"), *extra])
    same_tree(tmp_path / "jax", tmp_path / "port")
    x = rng.uniform(-10, 10, 50)
    np.testing.assert_array_equal(preprocess_real_data.wrap_angle(x), jax_prep.wrap_angle(x))


# ------------------------------------------------------------ annotations
def _annotation_db(path: Path) -> Path:
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE annotations (seq_name TEXT, annotation TEXT, task TEXT)")
    con.executemany("INSERT INTO annotations VALUES (?,?,?)",
                    [("seq-000100-000164", "open the drawer", "open_drawer"),
                     ("seq_000201_000265", " push the red block left ", "push_red_block_left"),
                     ("badname", "ignored", "x")])
    con.commit()
    con.close()
    return path


@pytest.mark.parametrize("divisor", [1, 2])
def test_annotation_db_matches_jax(tmp_path, divisor):
    db = _annotation_db(tmp_path / "ann.db")
    assert annotation_db.read_annotation_db(db) == jax_adb.read_annotation_db(db)
    jax_adb.main([str(db), "--out-dir", str(tmp_path / "jax"), "--frequency-divisor", str(divisor)])
    annotation_db.main([str(db), "--out-dir", str(tmp_path / "port"), "--frequency-divisor",
                        str(divisor)])
    same_tree(tmp_path / "jax", tmp_path / "port")


def _annotated(root: Path) -> None:
    write_play(root, [(0, 130), (131, 260)], task_at={40: 1, 200: 1})
    jax_ann.annotate_dataset(root, "lang_annotations", 64, 16, jax_ann.hash_embed)


@pytest.mark.parametrize("resample", [False, True])
def test_relabel_matches_jax(tmp_path, resample):
    a, b = twin(tmp_path, _annotated)
    want = jax_ann.relabel_dataset(a, embed_fn=lambda s: jax_ann.hash_embed(s, 24),
                                   resample=resample, seed=2)
    got = auto_lang_annotator.relabel_dataset(
        b, embed_fn=lambda s: auto_lang_annotator.hash_embed(s, 24), resample=resample, seed=2)
    assert got["language"]["ann"] == want["language"]["ann"] and len(want["language"]["ann"]) >= 2
    same_tree(a, b)


def test_task_statistics_and_cli_match_jax(tmp_path, capsys, monkeypatch):
    a, b = twin(tmp_path, _annotated)
    want = jax_ann.dataset_task_statistics(a)
    assert auto_lang_annotator.dataset_task_statistics(b) == want == {"open_drawer": 2}
    jax_ann.main([str(a), "--stats"])
    jax_out = capsys.readouterr().out
    auto_lang_annotator.main([str(b), "--stats"])
    assert capsys.readouterr().out == jax_out == "open_drawer: 2\n"
    for mod, d in ((jax_ann, a), (auto_lang_annotator, b)):
        mod.main([str(d), "--relabel", "--resample"])
        mod.main([str(d), "--lang-folder", "fresh"])
    same_tree(a, b)
    # relabelling without an encoder falls back to the hash stub only when allowed
    monkeypatch.delenv("HULC2_ALLOW_STUB_EMBEDDINGS", raising=False)
    for mod, d in ((jax_ann, a), (auto_lang_annotator, b)):
        with pytest.raises(RuntimeError, match="stub"):
            mod.relabel_dataset(d)


def test_lang_model_cli_needs_a_local_directory(tmp_path):
    write_play(tmp_path, [(0, 70)], task_at={30: 1})
    missing = tmp_path / "no-such-model"
    pytest.importorskip("transformers")
    with pytest.raises(FileNotFoundError, match="no-such-model"):
        auto_lang_annotator.main([str(tmp_path), "--lang-model", str(missing), "--device", "cpu"])


# ------------------------------------------------------------ viewers
def test_play_viewer_matches_jax(tmp_path):
    d = write_play(tmp_path / "play", [(0, 12), (13, 20)], hw=24, task_at={5: 1})
    jax_ann.annotate_dataset(d, "lang_annotations", 8, 4, jax_ann.hash_embed)
    assert visualize_dataset.load_annotation_spans(d) == jax_viz.load_annotation_spans(d)
    got = visualize_dataset.visualize_play(d, limit=15)
    want = [jax_viz.render_play_frame(i, f, jax_viz.load_annotation_spans(d).get(i))[:, :, ::-1]
            for _, (i, f) in zip(range(15), jax_viz.iter_play_frames(d))]
    assert len(got) == 15
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    frames = list(visualize_dataset.iter_play_frames(d, start=3, end=15))
    assert [i for i, _ in frames] == [i for i, _ in jax_viz.iter_play_frames(d, 3, 15)]


def write_labels(root: Path, n: int = 5, hw: int = 40) -> Path:
    """An affordance label directory: ``n`` validation frames with a pixel
    label, a depth and a caption."""
    rng = np.random.default_rng(6)
    files = []
    for i in range(n):
        d = root / "validation_episode_00" / "data" / "static_cam"
        d.mkdir(parents=True, exist_ok=True)
        np.savez(d / f"frame_{i:07d}.npz", frame=rng.integers(0, 256, (hw, hw, 3), np.uint8),
                 centers=np.array([[0, int(rng.integers(hw)), int(rng.integers(hw))]]),
                 depth=np.float32(0.5 + i), lang_ann="open the drawer")
        files.append(f"frame_{i:07d}")
    split = {"training": {}, "validation": {"validation_episode_00": {"static_cam": files}},
             "norm_values": {"depth": {"static_cam": {"mean": 1.0, "std": 0.5}}}}
    (root / "episodes_split.json").write_text(json.dumps(split))
    return root


def test_affordance_labels_preview_matches_jax(tmp_path):
    labels = write_labels(tmp_path / "labels")
    jax_viz.visualize_affordance(labels, out_dir=tmp_path / "jax", n=4)
    assert visualize_dataset.visualize_affordance(labels, out_dir=tmp_path / "port", n=4) is None
    same_tree(tmp_path / "jax", tmp_path / "port")
    assert len(list((tmp_path / "port").glob("sample_*.png"))) == 4


def _detector_run(tmp_path: Path, group: str) -> Path:
    """A saved affordance run of ``group`` at 64 px (random weights)."""
    from _torch_port_affordance import configs

    from hulc2_torch.affordance.train_affordance import build_detector
    from hulc2_torch.core.checkpoint import CheckpointManager, save_run_config

    run = tmp_path / group
    cfg = configs(group, ["batch_size=2", "num_workers=1"])[1]
    save_run_config(run, {**cfg, "depth_norm": {"mean": 1.0, "std": 0.5}})
    CheckpointManager(run).save(1, build_detector(cfg["aff_detection"]), None)
    return run


def test_affordance_preview_with_a_64px_detector(tmp_path):
    """The marker question of this slice: JAX's preview builds its dataset at
    the default ``img_resize`` (224) and scales the label by 224, so its
    marker sits on the label for a detector of any size; the port's scales by
    the dataset's ``img_resize`` and places it at the same pixel. The
    errors are the distances from the prediction to that marker."""
    from hulc2_tpu.affordance.dataset import AffordanceDataset as JaxDataset

    from hulc2_torch.evaluation.loading import load_affordance

    labels = write_labels(tmp_path / "labels")
    run = _detector_run(tmp_path, "rn18_pixel")
    summary = visualize_dataset.visualize_affordance(labels, run, tmp_path / "out", n=3,
                                                     device="cpu", images=False)
    assert json.loads((tmp_path / "out" / "errors.json").read_text()) == summary
    assert not list((tmp_path / "out").glob("*.png"))
    jds = JaxDataset(labels, "validation")
    predictor = load_affordance(run, device="cpu")
    for i, err in enumerate(summary["samples"]):
        s = jds[i]
        jax_xy = (int(s["px"][1] * s["frame"].shape[1] / 224),
                  int(s["px"][0] * s["frame"].shape[0] / 224))
        with np.load(labels / "validation_episode_00" / "data" / "static_cam"
                     / f"frame_{i:07d}.npz") as z:
            row, col = z["centers"][0, 1:]
        assert abs(jax_xy[0] - col) <= 1 and abs(jax_xy[1] - row) <= 1
        pred = predictor.predict(s["frame"], jax_ann.hash_embed([s["lang_ann"]], 16)[0])
        assert err["px_error"] == pytest.approx(np.hypot(pred["pixel"][0] - jax_xy[0],
                                                         pred["pixel"][1] - jax_xy[1]))
        assert err["depth_error"] == pytest.approx(abs(pred["depth"] - float(s["depth"])))
    assert summary["mean_depth_error"] >= 0


def test_affordance_preview_refuses_a_token_detector(tmp_path):
    """JAX's preview feeds every detector a float hash vector, and its token
    detector fails on it at init with an assertion; the port refuses it by
    name before it loads anything."""
    import hulc2_tpu.configs  # noqa: F401
    import hulc2_tpu.configs.affordance  # noqa: F401
    from hulc2_tpu.core import config as jax_cfg

    from _torch_port_affordance import SMALL

    labels = write_labels(tmp_path / "labels")
    run = _detector_run(tmp_path, "rn18_tokens_pixel")
    with pytest.raises(ValueError, match="token ids"):
        visualize_dataset.visualize_affordance(labels, run, tmp_path / "out", device="cpu")
    jrun = tmp_path / "jax_run"
    jrun.mkdir()
    jcfg = jax_cfg.compose("train_affordance", ["aff_detection=rn18_tokens_pixel", *SMALL])
    (jrun / "config.json").write_text(json.dumps(jcfg))
    with pytest.raises(AssertionError, match="expects int token ids"):
        jax_viz.visualize_affordance(labels, str(jrun), tmp_path / "jax_out")


def test_merge_frame_matches_jax():
    rng = np.random.default_rng(7)
    aff, static, grip = (rng.integers(0, 256, s, np.uint8) for s in
                         ((30, 30, 3), (65, 80, 3), (40, 40, 3)))
    np.testing.assert_array_equal(
        make_seq_videos.merge_frame(aff, static, grip, "1. open the drawer", "Model-based policy"),
        jax_msv.merge_frame(aff, static, grip, "1. open the drawer", "Model-based policy"))


def test_sequence_video_matches_jax(tmp_path):
    imageio = pytest.importorskip("imageio.v2")
    seq = tmp_path / "sequence_000"
    for task, policy in (("00_open_drawer", "model_based"), ("01_push", "model_free")):
        for cam in ("static_cam", "gripper_cam"):
            (seq / task / policy / cam).mkdir(parents=True)
            for i in range(2):
                imageio.imwrite(seq / task / policy / cam / f"{i:03d}.png",
                                np.full((48, 48, 3), 40 * i + 10, np.uint8))
    imageio.imwrite(seq / "00_open_drawer" / "aff_pred_0.png", np.full((20, 20, 3), 200, np.uint8))
    (seq / "sequence_tasks.txt").write_text("open the drawer\n")
    want = jax_msv.make_sequence_video(seq, fps=5, out_path=tmp_path / "jax.mp4")
    got = make_seq_videos.make_sequence_video(seq, fps=5, out_path=tmp_path / "port.mp4")
    assert got.suffix == want.suffix
    a, b = imageio.mimread(want), imageio.mimread(got)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(FileNotFoundError):
        (tmp_path / "empty" / "00_task").mkdir(parents=True)
        make_seq_videos.make_sequence_video(tmp_path / "empty")


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("gpus", [1, 4])
def test_sbatch_is_jax_template_for_the_card(tmp_path, gpus):
    jax_text = jax_launch.generate_sbatch(tmp_path / "jax", overrides=["a=1"]).read_text()
    text = launch.generate_sbatch(tmp_path / "port", overrides=["a=1"], gpus=gpus).read_text()
    command = ("python -m hulc2_torch.training" if gpus == 1
               else f"torchrun --nproc_per_node {gpus} -m hulc2_torch.training")
    expect = (jax_text.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
              .replace("hulc2_tpu", "hulc2_torch").replace("--partition=tpu", "--partition=gpu")
              .replace("python -m hulc2_torch.training", command)
              .replace("#SBATCH --output", f"#SBATCH --gres=gpu:{gpus}\n#SBATCH --output"))
    assert text == expect
    assert f"{command} --run-dir {tmp_path / 'port'} a=1" in text and "sbatch $0" in text
    assert (tmp_path / "port" / "resume_training.sh").read_text() == \
        f"#!/bin/bash\nsbatch {tmp_path / 'port' / 'sbatch.sh'}\n"
    evaluation = launch.generate_sbatch(
        tmp_path / "eval", command="python -m hulc2_torch.evaluation.evaluate_policy",
        overrides=["--train-dir", "R"]).read_text()
    assert "--run-dir" not in evaluation and "evaluate_policy --train-dir R" in evaluation
    launch.main(["sbatch", "--run-dir", str(tmp_path / "cli"), "--gpus", str(gpus), "a=1"])
    assert (tmp_path / "cli" / "sbatch.sh").read_text() == text.replace(
        str(tmp_path / "port"), str(tmp_path / "cli"))


def test_watchdog_restarts_and_backs_off(tmp_path, monkeypatch):
    count = tmp_path / "count"
    script = tmp_path / "s.py"
    script.write_text("import sys, pathlib\n"
                      f"f = pathlib.Path({str(count)!r})\n"
                      "n = int(f.read_text()) if f.exists() else 0\n"
                      "f.write_text(str(n + 1))\n"
                      "sys.exit(0 if n >= 2 else 'same failure')\n")
    sleeps = []
    monkeypatch.setattr(launch.time, "sleep", sleeps.append)
    assert launch.watchdog([sys.executable, str(script)], max_restarts=3, same_error_limit=2,
                           backoff_s=7.0) == 0
    assert count.read_text() == "3" and sleeps == [7.0]
    # a run that always fails the same way: both packages back off after
    # every second failure and give up after max_restarts
    always = tmp_path / "fail.py"
    always.write_text("import sys\nsys.exit('same failure')\n")
    sleeps.clear()
    assert launch.watchdog([sys.executable, str(always)], max_restarts=4, same_error_limit=2,
                           backoff_s=3.0) == 1
    port_sleeps = list(sleeps)
    sleeps.clear()  # time.sleep is one function for both packages
    assert jax_launch.watchdog([sys.executable, str(always)], max_restarts=4, same_error_limit=2,
                               backoff_s=3.0) == 1
    assert port_sleeps == sleeps == [3.0, 3.0]
