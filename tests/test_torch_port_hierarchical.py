"""The port's hierarchical (HULC++) mode against the JAX package, on the CPU.

The approach controller, the camera's projection and deprojection, the fake
env's absolute actions, and the batched evaluator's approach phase: the same
scripted agent and the same stub predictor on both sides give the same
results, subtask records and counters. Then the CLI chain on the CPU: a tiny
detector trained by ``train_affordance --synthetic`` drives
``evaluate_policy --aff-train-dir``.
"""
import json
import logging

import numpy as np
import pytest

import hulc2_tpu.envs.calvin_wrapper as jax_wrapper
import hulc2_tpu.envs.fake_env as jax_fake_env
import hulc2_tpu.evaluation.batched_eval as jax_batched
from hulc2_tpu.agents.approach import ApproachController as JaxApproach
from hulc2_torch.agents.approach import ApproachController
from hulc2_torch.envs import calvin_wrapper, fake_env
from hulc2_torch.envs.camera import PinholeCamera
from hulc2_torch.evaluation import batched_eval, sequences, tasks
from test_torch_port_eval_host import TINY, ScriptedAgent

TARGET = np.array([0.1, -0.3, 0.5])
AFF_TINY = ["aff_detection.decoder_channels=[32,16,8,8,8]", "aff_detection.lang_embed_dim=16",
            "aff_detection.tower_width=32", "aff_detection.tower_heads=2",
            "aff_detection.dataset.img_resize.static=64", "batch_size=2", "num_workers=1"]


@pytest.mark.parametrize("single_stage", [False, True])
def test_approach_trajectory_equals_jax(single_stage):
    """Every action of an approach, each applied to the port's and the JAX
    fake env, exactly; the port env's state equals the JAX env's after each."""
    ours, theirs = fake_env.FakeCalvinEnv(), jax_fake_env.FakeCalvinEnv()
    make = "single_stage" if single_stage else "__call__"
    ctl = (ApproachController.single_stage if single_stage else ApproachController)(
        ours.robot_obs[:3], TARGET, gripper_action=-1.0 if single_stage else 1.0)
    jctl = (JaxApproach.single_stage if single_stage else JaxApproach)(
        theirs.robot_obs[:3], TARGET, gripper_action=-1.0 if single_stage else 1.0)
    n = 0
    while True:
        a = ctl.action(ours.robot_obs[:3], ours.robot_obs[3:6])
        b = jctl.action(theirs.robot_obs[:3], theirs.robot_obs[3:6])
        assert (a is None) == (b is None), make
        if a is None:
            break
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        ours.step(a)
        theirs.step(b)
        np.testing.assert_array_equal(ours.robot_obs, theirs.robot_obs)
        np.testing.assert_array_equal(ours.scene_obs, theirs.scene_obs)
        n += 1
    assert ctl.done and ctl.n_steps == jctl.n_steps == n > 0
    assert np.linalg.norm(ours.robot_obs[:3] - TARGET) < 0.02


def test_camera_equals_jax():
    """project, deproject, deproject_single_depth and to_params of the fake
    env's static camera, exactly; deprojection inverts projection."""
    from hulc2_tpu.envs.camera import PinholeCamera as JaxCamera

    env, jenv = fake_env.FakeCalvinEnv(static_hw=96), jax_fake_env.FakeCalvinEnv(static_hw=96)
    cam, jcam = PinholeCamera(**env.get_camera_params()), JaxCamera(**jenv.get_camera_params())
    params, jparams = env.get_camera_params(), jenv.get_camera_params()
    assert sorted(params) == sorted(jparams)
    for k in params:
        np.testing.assert_array_equal(params[k], jparams[k])
    rng = np.random.default_rng(0)
    depth_map = rng.uniform(0.8, 1.6, (96, 96))
    for _ in range(20):
        p = rng.uniform([-0.4, -0.5, 0.3], [0.4, 0.3, 0.8])
        uv = cam.project(p)
        np.testing.assert_array_equal(uv, jcam.project(p))
        np.testing.assert_array_equal(cam.project(np.append(p, 1.0)), uv)
        d = float((cam.T_cam_world @ np.append(p, 1.0))[2])
        np.testing.assert_allclose(cam.deproject_single_depth(uv, d), p, atol=1e-12)
        np.testing.assert_array_equal(cam.deproject_single_depth(uv, d, homogeneous=True),
                                      jcam.deproject_single_depth(uv, d, homogeneous=True))
        px = rng.uniform(-5, 100, 2)
        np.testing.assert_array_equal(cam.deproject(px, depth_map), jcam.deproject(px, depth_map))


class StubPredictor:
    """A deterministic detector stand-in: pixel and depth from the frame's bytes,
    so that some predictions fall near the TCP and most do not."""

    def __init__(self):
        self.batch_sizes = []

    def _one(self, img):
        img = np.asarray(img, np.int64)
        return {"pixel": (int(img[..., 0].sum()) % 96, int(img[..., 1].sum()) % 96),
                "depth": 1.0 + (int(img.sum()) % 50) / 100.0}

    def predict(self, img, lang):
        self.batch_sizes.append(1)
        return self._one(img)

    def predict_batch(self, imgs, langs):
        self.batch_sizes.append(len(imgs))
        return [self._one(im) for im in imgs]


def _run_hierarchical(module, fake_env_module, farm_module, n_chains=4, ep_len=20, k=2):
    lang = {t: np.arange(4, dtype=np.int32) + 10 * i for i, t in enumerate(tasks.TASK_NAMES)}
    goal_tasks = {v.tobytes(): t for t, v in lang.items()}
    farm = farm_module.EnvFarm([fake_env_module.FakeCalvinEnv(static_hw=96, gripper_hw=64,
                                                              render_obs=False) for _ in range(k)])
    agent, pred = ScriptedAgent(k, goal_tasks, seed=0), StubPredictor()
    ev = module.PipelinedEvaluator([(farm, agent)], lang, ep_len=ep_len, affordance=pred,
                                   aff_lang_embeddings=lang)
    results = ev.evaluate(sequences=sequences.get_sequences(n_chains), progress=False)
    return ev, results, agent, pred


def test_hierarchical_evaluator_equals_jax():
    """2 envs x 4 chains: results, subtask records (approach steps included),
    the three counters, the agent's carry resets and the prediction batches."""
    ours, r_ours, a_ours, p_ours = _run_hierarchical(batched_eval, fake_env, calvin_wrapper)
    theirs, r_theirs, a_theirs, p_theirs = _run_hierarchical(jax_batched, jax_fake_env, jax_wrapper)
    assert r_ours == r_theirs and len(r_ours) == 4
    assert ours.subtask_records == theirs.subtask_records
    counters = ("n_aff_predictions", "n_approaches", "n_approach_steps")
    assert [getattr(ours, c) for c in counters] == [getattr(theirs, c) for c in counters]
    assert a_ours.resets == a_theirs.resets
    assert p_ours.batch_sizes == p_theirs.batch_sizes and p_ours.batch_sizes[0] == 2
    # one prediction per subtask start, and every started subtask has a record
    assert ours.n_aff_predictions == len(ours.subtask_records)
    assert 0 < ours.n_approaches < ours.n_aff_predictions and ours.n_approach_steps > 0
    assert ours.total_env_steps == theirs.total_env_steps
    assert ours.timings["aff_flush_s"] > 0.0


def test_make_approach_equals_jax():
    """The unbatched query: the same approach (or none) on both sides."""
    pred = StubPredictor()
    for seed in range(3):
        env, jenv = fake_env.FakeCalvinEnv(static_hw=96), jax_fake_env.FakeCalvinEnv(static_hw=96)
        rng = np.random.default_rng(seed)
        robot = env.robot_obs.copy()
        robot[:3] += rng.uniform(-0.1, 0.1, 3)
        obs, jobs = env.reset(robot_obs=robot), jenv.reset(robot_obs=robot)
        ev = batched_eval.PipelinedEvaluator([], {"t": np.zeros(4, np.int32)}, affordance=pred,
                                             aff_lang_embeddings={"t": np.zeros(4, np.int32)})
        jev = jax_batched.PipelinedEvaluator([], {"t": np.zeros(4, np.int32)}, affordance=pred,
                                             aff_lang_embeddings={"t": np.zeros(4, np.int32)})
        a, b = ev.make_approach(env, obs, "t"), jev.make_approach(jenv, jobs, "t")
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.target_pos, b.target_pos)
        assert (ev.n_aff_predictions, ev.n_approaches) == (jev.n_aff_predictions, jev.n_approaches)


def test_cli_chain_on_cpu(tmp_path, caplog):
    """``train_affordance --synthetic`` at tiny width, then ``evaluate_policy
    --aff-train-dir`` on the CPU: the log and eval_diagnostics.json carry the
    hierarchical counters, with approaches."""
    from hulc2_torch.affordance import train_affordance
    from hulc2_torch.evaluation import evaluate_policy

    aff_dir = tmp_path / "aff"
    res = train_affordance.main(["--synthetic", "--device", "cpu", "--max-steps", "2",
                                 "--run-dir", str(aff_dir), *AFF_TINY])
    assert res.step == 2 and (aff_dir / "saved_models" / "2.pt").is_file()
    cfg = json.loads((aff_dir / "config.json").read_text())
    assert cfg["depth_norm"] == {"mean": 0.0, "std": 1.0}
    assert all(np.isfinite(v) for line in res.history + res.val_history for v in line.values())
    with caplog.at_level(logging.INFO, logger="hulc2_torch.evaluation.evaluate_policy"):
        evaluate_policy.main(["--synthetic", "--fake-env", "--device-render", "--n-envs", "3",
                              "--cohorts", "2", "--num-sequences", "3", "--ep-len", "4",
                              "--aff-train-dir", str(aff_dir), "--log-dir", str(tmp_path / "ev"),
                              "--device", "cpu", *TINY])
    line = [r.getMessage() for r in caplog.records if r.getMessage().startswith("hierarchical mode")]
    assert len(line) == 1
    diag = json.loads((tmp_path / "ev" / "eval_diagnostics.json").read_text())
    h = diag["hierarchical"]
    assert line[0] == (f"hierarchical mode: {h['aff_predictions']} affordance predictions, "
                       f"{h['approaches']} approaches, {h['approach_steps']} approach steps")
    assert h["aff_predictions"] == len(diag["subtask_records"]) and h["approaches"] > 0
    assert h["approach_steps"] == sum(r["approach_steps"] for r in diag["subtask_records"]) > 0


def test_cli_refuses_unloadable_affordance_dirs(tmp_path):
    from hulc2_torch.evaluation import evaluate_policy

    (tmp_path / "no_ckpt").mkdir()
    (tmp_path / "no_ckpt" / "config.json").write_text(json.dumps({"aff_detection": {}}))
    (tmp_path / "policy_cfg" / "saved_models").mkdir(parents=True)
    (tmp_path / "policy_cfg" / "config.json").write_text(json.dumps({"model": {}}))
    (tmp_path / "policy_cfg" / "saved_models" / "3.pt").write_bytes(b"")
    (tmp_path / "rn18_pixel" / "saved_models").mkdir(parents=True)
    (tmp_path / "rn18_pixel" / "config.json").write_text(json.dumps(
        {"aff_detection": {"encoder_name": "resnet18", "fusion_type": "mult",
                           "depth_dist": "gaussian", "text_tower": False}}))
    (tmp_path / "rn18_pixel" / "saved_models" / "3.pt").write_bytes(b"")
    for extra in (["--aff-train-dir", str(tmp_path / "missing")],
                  ["--aff-train-dir", str(tmp_path / "rn18_pixel")],
                  ["--aff-train-dir", str(tmp_path / "no_ckpt")],
                  ["--aff-train-dir", str(tmp_path / "policy_cfg")],
                  ["--aff-checkpoint", "3"]):
        with pytest.raises(SystemExit):
            evaluate_policy.main(["--synthetic", "--fake-env", "--device", "cpu", *extra])
