"""The port's CALVIN simulator backends against the JAX package, on the CPU.

The recorded calvin_env contract (``tests/mock_calvin_env``): every case of
``tests/test_calvin_contract.py``, run on both packages; the port's and JAX's
wrappers give equal observations, camera parameters and oracle sets on the
same mock env. The process env farm: the port's ``ProcessEnvFarm`` against
its ``EnvFarm`` and JAX's ``ProcessEnvFarm``, step for step. The real env's
evaluators: the batched evaluator over farms of wrapped mock envs (in this
process and in worker processes) and the serial ``harness.evaluate_policy``
against JAX's, with stub agents; the CLI on the CPU. And two repaired JAX
faults: the wrapper's info without scene_obs (the heuristic oracle's
``KeyError``), and the real branch's missing ``partial_results.json``.
"""
import importlib
import json
import os
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

import hulc2_tpu.envs.fake_env as jax_fake_env
from hulc2_torch.envs import calvin_wrapper, fake_env
from hulc2_torch.evaluation import sequences, tasks

MOCK_DIR = str(Path(__file__).parent / "mock_calvin_env")
PKGS = ["hulc2_tpu", "hulc2_torch"]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture()
def mock_calvin(monkeypatch):
    """The mock calvin_env importable for one test, here and in env workers."""
    monkeypatch.syspath_prepend(MOCK_DIR)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([MOCK_DIR, os.environ.get("PYTHONPATH", "")]))
    yield
    for m in [m for m in sys.modules if m.split(".")[0] == "calvin_env"]:
        del sys.modules[m]


@pytest.fixture()
def dataset_dir(tmp_path):
    """A dataset root with the recorded render config get_env demands."""
    (tmp_path / ".hydra").mkdir()
    (tmp_path / ".hydra" / "merged_config.yaml").write_text("env: {}\ncameras: {}\n")
    return tmp_path


def _scene(slider=0.0, drawer=0.0, lightbulb=0.0, led=0.0, red=(0.0, 0.0, 0.46), red_yaw=0.0):
    s = np.zeros(24)
    s[0], s[1], s[4], s[5] = slider, drawer, lightbulb, led
    s[6:9] = red
    s[11] = red_yaw
    s[12:15] = (0.2, -0.1, 0.46)
    s[18:21] = (-0.2, -0.1, 0.46)
    return s


# ---- the calvin_env contract, case for case on both packages ----------- #
@pytest.mark.parametrize("pkg", PKGS)
class TestContract:
    def test_importerror_without_package(self, pkg):
        assert "calvin_env" not in sys.modules
        with pytest.raises(ImportError, match="calvin_env is not installed"):
            mod(pkg, "envs.calvin_wrapper").make_calvin_env("/nonexistent")

    def test_builds_from_dataset_render_config(self, pkg, mock_calvin, dataset_dir):
        env = mod(pkg, "envs.calvin_wrapper").make_calvin_env(dataset_dir, show_gui=False)
        assert env.show_gui is False and len(env.cameras) == 2

    def test_missing_render_config_raises(self, pkg, mock_calvin, tmp_path):
        with pytest.raises(FileNotFoundError, match="merged_config"):
            mod(pkg, "envs.calvin_wrapper").make_calvin_env(tmp_path)

    def test_reset_roundtrip_and_obs_shape(self, pkg, mock_calvin, dataset_dir):
        env = mod(pkg, "envs.calvin_wrapper").make_wrapped_calvin_env(dataset_dir)
        scene, robot = _scene(drawer=0.2), np.arange(15.0)
        obs = env.reset(robot_obs=robot, scene_obs=scene)
        assert set(obs) == {"rgb_obs", "depth_obs", "robot_obs", "scene_obs"}
        assert obs["rgb_obs"]["rgb_static"].shape == (200, 200, 3)
        np.testing.assert_array_equal(obs["scene_obs"], scene)
        np.testing.assert_array_equal(obs["robot_obs"], robot)
        obs2 = env.reset(state_info={"robot_obs": robot * 0, "scene_obs": scene * 0})
        assert obs2["robot_obs"].sum() == 0

    def test_step_action_types(self, pkg, mock_calvin, dataset_dir):
        env = mod(pkg, "envs.calvin_wrapper").make_wrapped_calvin_env(dataset_dir)
        env.reset(robot_obs=np.zeros(15), scene_obs=_scene())
        obs, _, _, info = env.step(np.array([1, 0, 0, 0, 0, 0, 1.0]))
        assert obs["robot_obs"][0] > 0 and obs["robot_obs"][6] == 1.0
        assert "scene_info" in info and "robot_info" in info
        obs, _, _, _ = env.step(([0.5, 0.1, 0.6], [0.0, 0.0, 0.0], [-1.0]))
        np.testing.assert_allclose(obs["robot_obs"][:3], [0.5, 0.1, 0.6])
        assert obs["robot_obs"][6] == -1.0

    def test_camera_params_deproject(self, pkg, mock_calvin, dataset_dir):
        env = mod(pkg, "envs.calvin_wrapper").make_wrapped_calvin_env(dataset_dir)
        params = env.get_camera_params()
        assert params["width"] == 200 and params["K"].shape == (3, 3)
        cam = mod(pkg, "envs.camera").PinholeCamera.from_params(
            params["width"], params["height"], params["K"][0, 0], params["K"][1, 1],
            params["K"][0, 2], params["K"][1, 2], params["T_world_cam"], params["name"])
        np.testing.assert_allclose(cam.deproject_single_depth((100, 100), 1.2), [0, 0, 0],
                                   atol=1e-6)

    def test_packaged_config_discovery(self, pkg, mock_calvin):
        oracle_cls = mod(pkg, "envs.task_oracle").CalvinTaskOracle
        path = oracle_cls._find_tasks_config()
        assert path is not None and path.name == "new_playtable_tasks.yaml"
        assert oracle_cls()._oracle.num_tasks >= 10

    def test_scores_env_infos(self, pkg, mock_calvin, dataset_dir):
        env = mod(pkg, "envs.calvin_wrapper").make_wrapped_calvin_env(dataset_dir)
        start, end = _infos(env, _scene(drawer=0.0, led=0.0), _scene(drawer=0.2, led=1.0))
        tasks_ = ["open_drawer", "close_drawer", "turn_on_led", "turn_off_lightbulb"]
        got = mod(pkg, "envs.task_oracle").CalvinTaskOracle().get_task_info_for_set(start, end,
                                                                                    tasks_)
        assert got == {"open_drawer", "turn_on_led"}

    def test_block_tasks(self, pkg, mock_calvin, dataset_dir):
        env = mod(pkg, "envs.calvin_wrapper").make_wrapped_calvin_env(dataset_dir)
        start, end = _infos(env, _scene(red=(0.0, 0.0, 0.46), red_yaw=0.0),
                            _scene(red=(0.15, 0.0, 0.53), red_yaw=np.radians(70)))
        got = mod(pkg, "envs.task_oracle").CalvinTaskOracle().get_task_info_for_set(
            start, end, ["lift_red_block_table", "push_red_block_right", "rotate_red_block_left",
                         "rotate_red_block_right"])
        assert got == {"lift_red_block_table", "push_red_block_right", "rotate_red_block_left"}

    def test_prefers_native_when_real_env(self, pkg, mock_calvin):
        oracle = mod(pkg, "envs.task_oracle")
        assert oracle.native_oracle_available()
        assert type(oracle.make_oracle(real_env=True)).__name__ == "CalvinTaskOracle"

    def test_heuristic_fallback_without_package(self, pkg, caplog):
        oracle = mod(pkg, "envs.task_oracle")
        assert not oracle.native_oracle_available()
        assert type(oracle.make_oracle(real_env=True)).__name__ == "SceneObsTaskOracle"
        assert "calvin_env is not importable" in caplog.text

    def test_force_heuristic(self, pkg, mock_calvin):
        oracle = mod(pkg, "envs.task_oracle").make_oracle(real_env=True, force_heuristic=True)
        assert type(oracle).__name__ == "SceneObsTaskOracle"


def _infos(env, scene_a, scene_b):
    env.reset(robot_obs=np.zeros(15), scene_obs=scene_a)
    start = env.get_info()
    env.reset(robot_obs=np.zeros(15), scene_obs=scene_b)
    return start, env.get_info()


def test_wrappers_and_oracles_equal_jax(mock_calvin, dataset_dir):
    """Two mock envs, one under each wrapper: equal obs after resets, relative
    and absolute steps, equal camera parameters (the GL matrices' conversion),
    equal oracle sets; the port's info is calvin_env's plus the last obs's
    robot_obs and scene_obs."""
    from hulc2_tpu.envs import calvin_wrapper as jax_wrapper
    from hulc2_tpu.envs.task_oracle import CalvinTaskOracle as JaxOracle
    from hulc2_torch.envs.task_oracle import CalvinTaskOracle

    ours = calvin_wrapper.CalvinEnvWrapper(calvin_wrapper.make_calvin_env(dataset_dir))
    theirs = jax_wrapper.CalvinEnvWrapper(jax_wrapper.make_calvin_env(dataset_dir))
    for k, v in ours.get_camera_params().items():
        w = theirs.get_camera_params()[k]
        assert np.array_equal(v, w) if isinstance(v, np.ndarray) else v == w
    rng = np.random.default_rng(0)
    oracle, joracle = CalvinTaskOracle(), JaxOracle()
    for t in range(6):
        scene = _scene(drawer=0.2 * (t % 2), led=float(t % 3 == 0),
                       red=(0.05 * t, 0.0, 0.46 + 0.04 * (t % 2)))
        robot = rng.standard_normal(15)
        a, b = ours.reset(robot_obs=robot, scene_obs=scene), theirs.reset(robot_obs=robot,
                                                                          scene_obs=scene)
        start, jstart = ours.get_info(), theirs.get_info()
        action = rng.uniform(-1, 1, 7) if t % 2 else (rng.uniform(0, 0.5, 3), np.zeros(3), -1.0)
        (a, _, _, info), (b, _, _, jinfo) = ours.step(action), theirs.step(action)
        for key in ("robot_obs", "scene_obs"):
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(info[key], a[key])
        for group in ("rgb_obs", "depth_obs"):
            assert a[group].keys() == b[group].keys()
            for cam in a[group]:
                np.testing.assert_array_equal(a[group][cam], b[group][cam])
        assert {k: v for k, v in info.items() if k not in ("robot_obs", "scene_obs")} == jinfo
        names = list(oracle._oracle.tasks)
        assert oracle.get_task_info_for_set(start, info, names) == \
            joracle.get_task_info_for_set(jstart, jinfo, names)
        assert oracle.get_task_info_for_set(jstart, info, names) == \
            joracle.get_task_info_for_set(jstart, jinfo, names)


def test_heuristic_oracle_repaired_on_calvin_info(mock_calvin, dataset_dir):
    """JAX's wrapper passes calvin_env's info through, so its scene-obs oracle
    (``--heuristic-oracle``) raises ``KeyError: 'scene_obs'``; the port's
    info carries the last observation's scene_obs, and the oracle scores."""
    from hulc2_tpu.envs import calvin_wrapper as jax_wrapper
    from hulc2_tpu.envs.task_oracle import SceneObsTaskOracle as JaxHeuristic
    from hulc2_torch.envs.task_oracle import SceneObsTaskOracle

    env = calvin_wrapper.make_wrapped_calvin_env(dataset_dir)
    jenv = jax_wrapper.make_wrapped_calvin_env(dataset_dir)
    with pytest.raises(KeyError, match="scene_obs"):
        JaxHeuristic().get_task_info_for_set(*_infos(jenv, _scene(), _scene(drawer=0.2)),
                                             ["open_drawer"])
    start, end = _infos(env, _scene(), _scene(drawer=0.2))
    assert SceneObsTaskOracle().get_task_info_for_set(start, end, ["open_drawer"]) == {
        "open_drawer"}


# ---- the process env farm --------------------------------------------- #
@pytest.fixture(scope="module")
def farms():
    from hulc2_tpu.envs.process_farm import ProcessEnvFarm as JaxProcessEnvFarm
    from hulc2_torch.envs.process_farm import ProcessEnvFarm

    ours = ProcessEnvFarm([partial(fake_env.FakeCalvinEnv, static_hw=32, gripper_hw=32)] * 2)
    theirs = JaxProcessEnvFarm([partial(jax_fake_env.FakeCalvinEnv, static_hw=32, gripper_hw=32,
                                        seed=i) for i in range(2)])
    yield ours, theirs
    ours.close()
    theirs.close()


def _assert_obs_equal(a, b):
    for group in ("rgb_obs", "depth_obs"):
        assert a[group].keys() == b[group].keys()
        for cam in a[group]:
            np.testing.assert_array_equal(a[group][cam], b[group][cam])
    for key in ("robot_obs", "scene_obs"):
        np.testing.assert_array_equal(a[key], b[key])


def test_process_farm_equals_env_farm_and_jax(farms):
    """Resets, relative and absolute steps, get_obs and get_infos: the port's
    worker farm, its in-process farm and JAX's worker farm, step for step."""
    ours, theirs = farms
    local = calvin_wrapper.EnvFarm([fake_env.FakeCalvinEnv(static_hw=32, gripper_hw=32)
                                    for _ in range(2)])
    robot = np.stack([fake_env.NEUTRAL_ROBOT_OBS] * 2)
    robot[1, :3] += (0.05, -0.05, 0.02)
    scene = np.stack([_scene(drawer=0.1), _scene(led=1.0)])
    _assert_obs_equal(ours.reset(robot, scene), local.reset(robot, scene))
    _assert_obs_equal(ours.reset(robot, scene), theirs.reset(robot, scene))
    rng = np.random.default_rng(1)
    for t in range(4):
        actions = rng.uniform(-1, 1, (2, 7))
        if t == 2:
            actions = [(robot[i, :3] + 0.03, robot[i, 3:6], 1.0) for i in range(2)]
        (o, i), (lo, li), (jo, ji) = (f.step_all(actions) for f in (ours, local, theirs))
        for a, b, c in zip(o, lo, jo):
            _assert_obs_equal(a, b)
            _assert_obs_equal(a, c)
        for a, b in zip(i, ji):
            np.testing.assert_array_equal(a["scene_obs"], b["scene_obs"])
    stacked, rewards, dones, infos = ours.step(np.zeros((2, 7)))
    _assert_obs_equal(stacked, local.step(np.zeros((2, 7)))[0])
    _assert_obs_equal(ours.get_obs(), local.get_obs())
    for a, b in zip(ours.get_infos(), local.get_infos()):
        np.testing.assert_array_equal(a["robot_obs"], b["robot_obs"])
    assert ours.envs[0].get_camera_params()["width"] == 32


def test_process_farm_workers_and_errors(farms):
    """The workers never see the card nor import torch; a call's error and a
    worker's construction error are raised in the parent."""
    from hulc2_torch.envs.process_farm import ProcessEnvFarm

    ours, _ = farms
    info = ours.worker_info()
    assert len({w["pid"] for w in info}) == 2 and os.getpid() not in {w["pid"] for w in info}
    assert all(w["cuda_visible_devices"] == "" and w["torch_imported"] is False for w in info)
    with pytest.raises(RuntimeError, match="env worker error"):
        ours.envs[0].call("no_such_method")
    with pytest.raises(RuntimeError, match="failed to construct env"):
        ProcessEnvFarm([partial(fake_env.FakeCalvinEnv, no_such_argument=1)])


# ---- the real env's evaluators ---------------------------------------- #
class StubAgent:
    """Seeded host actions for K envs, for both packages' evaluators; the
    single-env surface (``reset``, ``step``, the approach counters) for the
    serial loop."""

    def __init__(self, n_envs: int, seed: int):
        self.n_envs = n_envs
        self.rng = np.random.default_rng(seed)
        self.captions = []
        self.n_aff_predictions = self.n_approaches = self.n_move_steps = 0

    def reset_env_slot(self, i):
        pass

    def reset(self, caption=None):
        self.captions.append(caption)

    def step_async(self, obs, goal):
        return self.rng.uniform(-1, 1, (self.n_envs, 7))

    def step(self, obs, goal):
        return self.rng.uniform(-1, 1, 7)


class StubPredictor:
    def _one(self, img):
        img = np.asarray(img, np.int64)
        return {"pixel": (int(img[..., 0].sum()) % 200 + 17, 60), "depth": 0.7}

    def predict(self, img, lang):
        return self._one(img)

    def predict_batch(self, imgs, langs):
        return [self._one(im) for im in imgs]


def _lang():
    return {t: np.arange(4, dtype=np.int32) + 10 * i for i, t in enumerate(tasks.TASK_NAMES)}


def _run_batched(pkg, dataset_dir, process: bool):
    wrapper, batched = mod(pkg, "envs.calvin_wrapper"), mod(pkg, "evaluation.batched_eval")
    cohorts = []
    for c in range(2):
        if process:
            farm = mod(pkg, "envs.process_farm").ProcessEnvFarm(
                [partial(wrapper.make_wrapped_calvin_env, str(dataset_dir))] * 2)
        else:
            farm = wrapper.EnvFarm([wrapper.make_wrapped_calvin_env(dataset_dir) for _ in range(2)])
        cohorts.append((farm, StubAgent(2, seed=c)))
    ev = batched.PipelinedEvaluator(cohorts, _lang(), ep_len=6,
                                    oracle=mod(pkg, "envs.task_oracle").CalvinTaskOracle(),
                                    affordance=StubPredictor(), aff_lang_embeddings=_lang())
    try:
        results = ev.evaluate(sequences=sequences.get_sequences(4), progress=False)
    finally:
        for farm, _ in cohorts:
            getattr(farm, "close", lambda: None)()
    return ev, results


def test_batched_real_env_evaluator_equals_jax(mock_calvin, dataset_dir):
    """Four chains over two cohorts of two wrapped mock envs, scored by the
    native oracle, the hierarchical approach on: the port's results and
    subtask records equal JAX's, in this process and with the port's envs in
    worker processes."""
    ev, results = _run_batched("hulc2_torch", dataset_dir, process=False)
    jev, jresults = _run_batched("hulc2_tpu", dataset_dir, process=False)
    pev, presults = _run_batched("hulc2_torch", dataset_dir, process=True)
    assert results == jresults == presults and len(results) == 4
    assert ev.subtask_records == jev.subtask_records == pev.subtask_records
    assert (ev.n_aff_predictions, ev.n_approaches, ev.n_approach_steps) == \
        (jev.n_aff_predictions, jev.n_approaches, jev.n_approach_steps)
    assert ev.n_approaches > 0 and ev.n_approach_steps == pev.n_approach_steps > 0


def test_serial_harness_equals_jax(mock_calvin, dataset_dir):
    """``harness.evaluate_policy`` over one wrapped mock env with a stub agent
    and the native oracle, against JAX's loop and rollout: equal results,
    equal captions, the same last robot state; the port's rollout records one
    subtask per attempt."""
    from hulc2_tpu.envs.task_oracle import CalvinTaskOracle as JaxOracle
    from hulc2_tpu.evaluation import evaluate_policy as jax_eval
    from hulc2_tpu.evaluation import harness as jax_harness
    from hulc2_torch.envs.task_oracle import CalvinTaskOracle
    from hulc2_torch.evaluation import evaluate_policy, harness

    t2a = {t: f"sentence {i}" for i, t in enumerate(tasks.TASK_NAMES)}
    goals = {a: np.full(8, i, np.float32) for i, a in enumerate(t2a.values())}
    seqs = sequences.get_sequences(4)
    env = calvin_wrapper.make_wrapped_calvin_env(dataset_dir)
    agent = StubAgent(1, seed=3)
    rollout = evaluate_policy.make_policy_rollout_fn(agent, CalvinTaskOracle(), t2a, goals, 5)
    results = harness.evaluate_policy(rollout, env, sequences=seqs, progress=False)
    jenv = mod("hulc2_tpu", "envs.calvin_wrapper").make_wrapped_calvin_env(dataset_dir)
    jagent = StubAgent(1, seed=3)
    jrollout = jax_eval.make_policy_rollout_fn(jagent, JaxOracle(), t2a, goals, 5)
    jresults = jax_harness.evaluate_policy(jrollout, jenv, sequences=seqs, progress=False)
    assert results == jresults and len(results) == 4
    assert agent.captions == jagent.captions == [t2a[c[0]] for _, c in seqs]
    np.testing.assert_array_equal(env.get_obs()["robot_obs"], jenv.get_obs()["robot_obs"])
    assert [r["task"] for r in rollout.subtask_records] == [c[0] for _, c in seqs]
    assert rollout.n_dispatches == 5 * len(seqs) == rollout.total_env_steps


# ---- the CLI ----------------------------------------------------------- #
def _cli_fixture(tmp_path):
    from _torch_port_affordance import SMALL, configs
    from test_torch_port_affordance_cli import _embeddings_file
    from test_torch_port_embedding_eval import _embedding_run
    from test_torch_port_host_loader import write_low_level_dir

    from hulc2_torch.affordance import train_affordance
    from hulc2_torch.core.checkpoint import CheckpointManager, save_run_config

    data = write_low_level_dir(tmp_path / "data", 16, 16)
    (data / ".hydra").mkdir()
    (data / ".hydra" / "merged_config.yaml").write_text("env: {}\n")
    aff = tmp_path / "aff"
    cfg = configs("rn18_pixel", [*SMALL, "batch_size=2", "num_workers=1"])[1]
    save_run_config(aff, {**cfg, "depth_norm": {"mean": 0.0, "std": 1.0}})
    CheckpointManager(aff).save(1, train_affordance.build_detector(cfg["aff_detection"]), None)
    return data, aff, _embeddings_file(tmp_path / "aff_emb.npy", 16), _embedding_run(tmp_path / "run")


def test_real_env_cli_on_cpu(tmp_path, monkeypatch, mock_calvin):
    """``evaluate_policy`` without ``--fake-env`` on the mock: batched in this
    process, batched with ``--process-envs`` and serial with a detector over
    the dataset's embeddings, then serial with ``--heuristic-oracle``. The
    native oracle scores, the results and the records agree between the
    farms, the workers report no card, the serial run predicts once per
    subtask and approaches, the partial file is written (the repaired fault
    3, shown against JAX's branch below)."""
    import torch

    from hulc2_torch.evaluation import evaluate_policy

    monkeypatch.setenv("HULC2_SEQUENCES_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    data, aff, aff_emb, run = _cli_fixture(tmp_path)
    common = ["--train-dir", str(run), "--dataset-path", str(data), "--num-sequences", "3",
              "--ep-len", "2", "--device", "cpu"]
    out = {}
    try:
        for name, extra in (("farm", ["--n-envs", "2", "--cohorts", "2"]),
                            ("process", ["--n-envs", "2", "--cohorts", "2", "--process-envs"]),
                            ("serial", ["--aff-train-dir", str(aff), "--aff-lang-embeddings",
                                        str(aff_emb)]),
                            ("heuristic", ["--heuristic-oracle"])):
            log_dir = tmp_path / name
            merged = evaluate_policy.main(common + extra + ["--log-dir", str(log_dir)])
            diag = json.loads((log_dir / "eval_diagnostics.json").read_text())
            partial = json.loads((log_dir / "partial_results.json").read_text()) \
                if (log_dir / "partial_results.json").is_file() else None
            out[name] = (merged["latest"], diag, partial)
    finally:
        torch.set_num_threads(threads)
    assert out["farm"][0] == out["process"][0] == out["serial"][0] == out["heuristic"][0]
    assert out["farm"][1]["subtask_records"] == out["process"][1]["subtask_records"]
    assert out["farm"][2]["completed_chains"] == out["process"][2]["completed_chains"] == 3
    assert [d["oracle"] for _, d, _ in out.values()] == ["CalvinTaskOracle"] * 3 + [
        "SceneObsTaskOracle"]
    workers = out["process"][1]["env_workers"]
    assert len(workers) == 2 and all(w["cuda_visible_devices"] == "" and not w["torch_imported"]
                                     for w in workers)
    serial = out["serial"][1]
    h = serial["hierarchical"]
    assert h["aff_predictions"] == len(serial["subtask_records"]) == 3 and h["approaches"] > 0
    assert h["approach_steps"] == sum(r["approach_steps"] for r in serial["subtask_records"]) > 0
    assert serial["dispatches"] == 6 and serial["total_env_steps"] == 6 + h["approach_steps"]
    assert out["serial"][2] is None  # the serial loop has no evaluator snapshots


def test_real_env_partial_results_repaired(tmp_path, monkeypatch, mock_calvin):
    """JAX's batched real-env branch never sets ``partial_path``: its run
    leaves no partial_results.json (policy, statistics and agents stubbed so
    its CLI runs without a trained JAX run). The port's CLI sets it: its run
    leaves the file, the last snapshot holding every chain."""
    import hulc2_tpu.agents.hulc2_agent as jax_agent_mod
    import hulc2_tpu.evaluation.batched_eval as jax_batched
    import hulc2_tpu.evaluation.loading as jax_loading
    from hulc2_tpu.evaluation import evaluate_policy as jax_eval
    from hulc2_torch.evaluation import evaluate_policy

    monkeypatch.setenv("HULC2_SEQUENCES_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    data, _, _, run = _cli_fixture(tmp_path)
    made = []

    class Spy(jax_batched.PipelinedEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    class JaxStubAgent(StubAgent):
        def __init__(self, farm, model, params, dm, stats=None, n_envs=1, fused_step=None, **kw):
            super().__init__(n_envs, seed=0)
            self._fused_step = object()

    cfg = {"model": {}, "datamodule": {}}
    monkeypatch.setattr(jax_loading, "load_policy", lambda *a: (None, None, cfg))
    monkeypatch.setattr(jax_agent_mod, "Hulc2Agent", JaxStubAgent)
    monkeypatch.setattr(jax_batched, "PipelinedEvaluator", Spy)
    argv = ["--train-dir", str(run), "--dataset-path", str(data), "--n-envs", "2", "--cohorts",
            "2", "--num-sequences", "3", "--ep-len", "2"]
    jax_eval.main(argv + ["--log-dir", str(tmp_path / "jax")])
    (jev,) = made
    assert jev.partial_path is None and (tmp_path / "jax" / "results.json").is_file()
    assert not (tmp_path / "jax" / "partial_results.json").exists()
    evaluate_policy.main(argv + ["--log-dir", str(tmp_path / "port"), "--device", "cpu"])
    snap = json.loads((tmp_path / "port" / "partial_results.json").read_text())
    assert snap["completed_chains"] == snap["total_chains"] == 3
    ours = json.loads((tmp_path / "port" / "results.json").read_text())["latest"]
    theirs = json.loads((tmp_path / "jax" / "results.json").read_text())["latest"]
    assert ours == theirs


def test_interactive_on_the_mock(tmp_path, monkeypatch, mock_calvin, capsys):
    """``interactive`` without ``--fake-env``: a policy over sentence
    embeddings looks each instruction up in the dataset's table; one outside
    it is refused unless stub embeddings are allowed, then warned about."""
    import io

    from hulc2_torch.evaluation import interactive
    from hulc2_torch.tools.annotations import VALIDATION_BANK

    data, _, _, run = _cli_fixture(tmp_path)
    argv = ["--train-dir", str(run), "--dataset-path", str(data), "--ep-len", "3", "--device", "cpu"]
    known = VALIDATION_BANK["open_drawer"]
    monkeypatch.delenv("HULC2_ALLOW_STUB_EMBEDDINGS", raising=False)
    with pytest.raises(RuntimeError, match="HULC2_ALLOW_STUB_EMBEDDINGS"):
        interactive.main(argv, stdin=io.StringIO(f"{known}\nnot a sentence of the table\n"))
    monkeypatch.setenv("HULC2_ALLOW_STUB_EMBEDDINGS", "1")
    verdicts = interactive.main(argv, stdin=io.StringIO(f"{known}\nnot a sentence of the table\n"))
    assert [v[0] for v in verdicts] == [known, "not a sentence of the table"]
    assert all(v[1] is None and v[2] == 3 for v in verdicts)
    assert "is not in the embeddings table" in capsys.readouterr().out
