"""The port's single-env agents, the real-robot path, move_to_pt and the
miner's contact check against the JAX package, on the CPU.

``BaseAgent.move_to``/``move_to_pos`` and ``Hulc2Agent.reset(caption)`` on
the port's and JAX's fake envs: every env state of the approach equal to
1e-12. The repaired ``_robot_state`` on calvin_env's info (the recorded
contract in ``tests/mock_calvin_env``), where JAX raises ``KeyError``.
``RealWorldAgent``'s workspace clipping, ``real_world_eval.rollout`` and its
CLI over the fake env, ``test_move_to_pt.run`` against JAX's, and
``contact_verified`` with ``mine_labels(env=...)`` against a stub
``pybullet`` in both packages.
"""
import io
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import hulc2_torch.configs  # noqa: F401  (registers the config groups)
import hulc2_tpu.envs.fake_env as jax_fake_env
from hulc2_torch.envs import fake_env

MOCK_DIR = str(Path(__file__).parent / "mock_calvin_env")
TARGET = np.array([0.12, -0.25, 0.55])
LOW_TINY_MODEL = [
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.visual_goal.hidden_size=32",
    "model.language_goal.hidden_size=32", "model.action_decoder.hidden_size=32",
]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These small models gain nothing from torch's thread pool, and under
    pytest-xdist its threads would contend with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def mock_calvin(monkeypatch, tmp_path):
    """The mock calvin_env importable for one test; returns a dataset root with
    the recorded render config its ``get_env`` demands."""
    monkeypatch.syspath_prepend(MOCK_DIR)
    (tmp_path / ".hydra").mkdir()
    (tmp_path / ".hydra" / "merged_config.yaml").write_text("env: {}\ncameras: {}\n")
    yield tmp_path
    for mod in [m for m in sys.modules if m.split(".")[0] == "calvin_env"]:
        del sys.modules[mod]


class Recorder:
    """An env proxy that keeps a copy of robot_obs and scene_obs after each step."""

    def __init__(self, env):
        self.env = env
        self.states = []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, action):
        out = self.env.step(action)
        self.states.append(np.concatenate([self.env.robot_obs, self.env.scene_obs]))
        return out


def _assert_same_states(a, b):
    assert len(a.states) == len(b.states) > 0
    np.testing.assert_allclose(np.stack(a.states), np.stack(b.states), rtol=0, atol=1e-12)


# ---- the blocking approach -------------------------------------------- #
@pytest.mark.parametrize("single_stage", [False, True], ids=["move_to", "move_to_pos"])
def test_base_agent_trajectory_equals_jax(single_stage):
    from hulc2_tpu.agents.base_agent import BaseAgent as JaxBaseAgent
    from hulc2_torch.agents.base_agent import BaseAgent

    ours, theirs = Recorder(fake_env.FakeCalvinEnv()), Recorder(jax_fake_env.FakeCalvinEnv())
    agent, jagent = BaseAgent(ours), JaxBaseAgent(theirs)
    if single_stage:
        agent.move_to_pos(TARGET, agent.target_orn, -1.0)
        jagent.move_to_pos(TARGET, jagent.target_orn, -1.0)
    else:
        agent.move_to(TARGET, gripper_action=1)
        jagent.move_to(TARGET, gripper_action=1)
    _assert_same_states(ours, theirs)
    assert agent.n_move_steps == len(ours.states)
    assert np.linalg.norm(ours.env.robot_obs[:3] - TARGET) < 0.02


class StubPredictor:
    """A detector stand-in: pixel and depth from the frame's bytes; records the
    captions it was asked."""

    def __init__(self):
        self.captions = []

    def predict(self, img, lang):
        self.captions.append(lang)
        img = np.asarray(img, np.int64)
        return {"pixel": (int(img[..., 0].sum()) % 200, int(img[..., 1].sum()) % 200),
                "depth": 1.0 + (int(img.sum()) % 40) / 100.0}


def _agents(env, jenv, affordance):
    """The port's tiny cfg_low_level agent and JAX's over the same config (no
    parameters: reset never runs the policy)."""
    import hulc2_tpu.configs  # noqa: F401
    from hulc2_tpu.agents.hulc2_agent import Hulc2Agent as JaxAgent
    from hulc2_tpu.core import config as jax_cfg_lib
    from hulc2_tpu.models.build import build_policy as jax_build
    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.core import config as cfg_lib
    from hulc2_torch.models.build import build_policy_for

    cfg = cfg_lib.compose("cfg_low_level", LOW_TINY_MODEL)
    jcfg = jax_cfg_lib.compose("cfg_low_level", LOW_TINY_MODEL + ["model.compute_dtype=float32"])
    agent = Hulc2Agent(build_policy_for(cfg), cfg["datamodule"], env=env, affordance=affordance)
    jagent = JaxAgent(jenv, jax_build(jcfg["model"]), None, jcfg["datamodule"],
                      affordance=affordance)
    return agent, jagent


def test_reset_caption_approach_equals_jax():
    """``reset(caption)`` over three subtasks: the prediction, the projected
    TCP's distance, the approach's every env state, then the carry restarts."""
    pred = StubPredictor()
    ours, theirs = Recorder(fake_env.FakeCalvinEnv()), Recorder(jax_fake_env.FakeCalvinEnv())
    agent, jagent = _agents(ours, theirs, pred)
    for caption in ("open the drawer", "push the red block left", "turn on the led"):
        agent.reset(caption)
        jagent.reset(caption)
        _assert_same_states(ours, theirs)
        assert int(agent.carry.step.sum()) == 0
    assert pred.captions == [c for c in ("open the drawer", "push the red block left",
                                         "turn on the led") for _ in range(2)]
    assert agent.n_aff_predictions == 3 and agent.n_approaches >= 1
    assert agent.n_move_steps == len(ours.states)


def test_robot_state_repaired_on_calvin_info(mock_calvin):
    """calvin_env's info holds no robot_obs: JAX's ``_robot_state`` evaluates
    ``info["robot_obs"]`` as a default and raises at once, in ``move_to`` and
    in the single-env approach; the port reads robot_info and reaches the
    target."""
    from hulc2_tpu.agents.base_agent import BaseAgent as JaxBaseAgent
    from hulc2_tpu.envs.calvin_wrapper import make_wrapped_calvin_env as jax_make
    from hulc2_torch.agents.base_agent import BaseAgent
    from hulc2_torch.envs.calvin_wrapper import make_wrapped_calvin_env

    start = np.zeros(15)
    start[:3] = (0.0, -0.1, 0.6)
    jenv = jax_make(mock_calvin)
    jenv.reset(robot_obs=start, scene_obs=np.zeros(24))
    with pytest.raises(KeyError, match="robot_obs"):
        JaxBaseAgent(jenv).move_to(TARGET)
    env = make_wrapped_calvin_env(mock_calvin)
    env.reset(robot_obs=start, scene_obs=np.zeros(24))
    agent = BaseAgent(env)
    agent.move_to(TARGET)
    assert agent.n_move_steps > 0
    assert np.linalg.norm(env.get_obs()["robot_obs"][:3] - TARGET) < 0.02
    # the single-env hierarchical approach on the same env
    pred = StubPredictor()
    env.reset(robot_obs=start, scene_obs=np.zeros(24))
    jenv.reset(robot_obs=start, scene_obs=np.zeros(24))
    ours, theirs = _agents(env, jenv, pred)
    with pytest.raises(KeyError, match="robot_obs"):
        theirs.reset("open the drawer")
    ours.reset("open the drawer")
    assert ours.n_approaches == 1 and ours.n_move_steps > 0


# ---- the real robot --------------------------------------------------- #
def test_real_world_agent_clips_and_equals_jax():
    """A target outside the workspace: the approach ends at the clipped point,
    state for state as JAX's agent; the prediction is clipped too."""
    from hulc2_tpu.agents.real_world_agent import RealWorldAgent as JaxRW
    from hulc2_torch.agents.real_world_agent import RealWorldAgent
    from hulc2_torch.envs.panda_wrapper import DEFAULT_WORKSPACE

    ws = {"low": np.array([-0.3, -0.4, 0.45]), "high": np.array([0.3, 0.1, 0.62])}
    ours, theirs = Recorder(fake_env.FakeCalvinEnv()), Recorder(jax_fake_env.FakeCalvinEnv())
    base, jbase = _agents(None, None, None)
    agent = RealWorldAgent(base.model, _dm(), env=ours, affordance=StubPredictor(),
                           workspace=ws)
    jagent = JaxRW(theirs, jbase.model, None, _jax_dm(), affordance=StubPredictor(), workspace=ws)
    far = np.array([0.9, 0.5, 0.2])
    agent.move_to(far, gripper_action=1)
    jagent.move_to(far, gripper_action=1)
    _assert_same_states(ours, theirs)
    np.testing.assert_allclose(ours.env.robot_obs[:3], np.clip(far, ws["low"], ws["high"]),
                               atol=0.02)
    target, px = agent.get_aff_pred("open the drawer")
    jtarget, jpx = jagent.get_aff_pred("open the drawer")
    np.testing.assert_allclose(target, jtarget, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(px, jpx)
    assert np.all(target >= ws["low"]) and np.all(target <= ws["high"])
    assert RealWorldAgent(base.model, _dm()).workspace is DEFAULT_WORKSPACE


def _dm():
    from hulc2_torch.core import config as cfg_lib

    return cfg_lib.compose("cfg_low_level", LOW_TINY_MODEL)["datamodule"]


def _jax_dm():
    from hulc2_tpu.core import config as jax_cfg_lib

    return jax_cfg_lib.compose("cfg_low_level", LOW_TINY_MODEL)["datamodule"]


def test_real_world_rollout_moves_before_the_policy():
    """``real_world_eval.rollout`` on the fake env with a stub predictor: the
    approach moves the arm more than 5 cm, then the policy steps
    (``tests/test_extras.py:161-190``)."""
    from hulc2_torch.agents.real_world_agent import RealWorldAgent
    from hulc2_torch.core import config as cfg_lib
    from hulc2_torch.evaluation.real_world_eval import rollout
    from hulc2_torch.models.build import build_policy_for

    class StubAff:
        model = types.SimpleNamespace(lang_embed_dim=16)

        def predict(self, img, lang):
            return {"pixel": (180, 30), "depth": 1.1}

    cfg = cfg_lib.compose("cfg_low_level", LOW_TINY_MODEL)
    env = fake_env.FakeCalvinEnv(static_hw=200, gripper_hw=84)
    start = env.robot_obs[:3].copy()
    agent = RealWorldAgent(build_policy_for(cfg), cfg["datamodule"], env=env,
                           affordance=StubAff())
    assert rollout(agent, "open_drawer", np.zeros(384, np.float32), ep_len=2, move_robot=True,
                   show=False) == 2
    assert agent.n_approaches == 1 and agent.n_move_steps > 0
    assert np.linalg.norm(env.robot_obs[:3] - start) > 0.05
    assert int(agent.carry.step[0]) == 2


def test_real_world_eval_cli_on_the_fake_env(tmp_path):
    """The CLI with ``--env-factory`` the fake env, a token policy and a saved
    sentence detector with its ``--aff-lang-embeddings`` table: one prediction
    per instruction; a sentence outside the detector's table is printed and
    skipped. ``--show`` names cv2 where it is not installed."""
    from _torch_port_affordance import SMALL, configs
    from test_torch_port_affordance_cli import _embeddings_file
    from test_torch_port_eval_host import TINY

    from hulc2_torch.affordance import train_affordance
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.core.checkpoint import CheckpointManager, save_run_config
    from hulc2_torch.evaluation import real_world_eval
    from hulc2_torch.models.build import build_policy
    from hulc2_torch.tools.annotations import VALIDATION_BANK

    run = tmp_path / "run"
    cfg = flagship_config(TINY)
    save_run_config(run, cfg)
    CheckpointManager(run).save(1, build_policy(cfg["model"], seed=1), None)
    aff = tmp_path / "aff"
    acfg = configs("rn18_pixel", [*SMALL, "batch_size=2", "num_workers=1"])[1]
    save_run_config(aff, {**acfg, "depth_norm": {"mean": 0.0, "std": 1.0}})
    CheckpointManager(aff).save(1, train_affordance.build_detector(acfg["aff_detection"]), None)
    emb = _embeddings_file(tmp_path / "emb.npy", 16)
    argv = ["--train-dir", str(run), "--aff-train-dir", str(aff), "--aff-lang-embeddings", str(emb),
            "--env-factory", "hulc2_torch.envs.fake_env:FakeCalvinEnv", "--ep-len", "2",
            "--device", "cpu"]
    lines = [VALIDATION_BANK["open_drawer"], "an unknown sentence", VALIDATION_BANK["turn_on_led"]]
    agent = real_world_eval.main(argv, stdin=io.StringIO("\n".join(lines) + "\n\n"))
    assert agent.n_aff_predictions == 2 and type(agent.env).__name__ == "FakeCalvinEnv"
    if "cv2" not in sys.modules:
        try:
            import cv2  # noqa: F401
        except ImportError:
            with pytest.raises(ImportError, match="cv2"):
                real_world_eval.main(argv + ["--show"], stdin=io.StringIO(lines[0] + "\n"))


def test_panda_wrapper_scales_clips_and_names_robot_io():
    """Relative actions scaled by MAX_REL_*, absolute ones clipped to the
    workspace, robot_obs in the 15-d layout, equal to JAX's wrapper on the
    same stub robot; without ``env`` the missing robot_io is named."""
    from hulc2_tpu.envs.panda_wrapper import PandaLfpWrapper as JaxPanda
    from hulc2_torch.envs.panda_wrapper import PandaLfpWrapper

    class StubRobot:
        def __init__(self):
            self.targets = []

        def _get_obs(self):
            return {"rgb_static": np.zeros((4, 4, 3), np.uint8),
                    "depth_static": np.ones((4, 4), np.float32),
                    "robot_state": {"tcp_pos": [0.4, 0.0, 0.3], "tcp_orn": [0.0, 0.0, 0.38, 0.92],
                                    "gripper_opening_width": 0.07,
                                    "joint_positions": np.arange(7) * 0.1}}

        def reset(self, **kw):
            return self._get_obs()

        def step(self, target):
            self.targets.append(target)
            return self._get_obs(), 0.0, False, {}

    outs = []
    for cls in (PandaLfpWrapper, JaxPanda):
        robot = StubRobot()
        env = cls(env=robot)
        obs = env.reset()
        env.step(np.array([1.0, -0.5, 0.0, 0.2, 0.0, -1.0, -0.3]))
        env.step(([2.0, 0.0, -1.0], [3.1, 0.0, 0.0], 1))
        outs.append((obs, env.get_info(), robot.targets))
    (obs, info, targets), (jobs, jinfo, jtargets) = outs
    np.testing.assert_allclose(obs["robot_obs"], jobs["robot_obs"], rtol=0, atol=1e-12)
    assert obs["robot_obs"].shape == (15,) and set(obs["rgb_obs"]) == {"rgb_static"}
    np.testing.assert_allclose(info["robot_obs"], jinfo["robot_obs"], rtol=0, atol=1e-12)
    rel, jrel = targets[0]["motion"], jtargets[0]["motion"]
    np.testing.assert_allclose(rel[0], jrel[0], rtol=0, atol=1e-15)
    np.testing.assert_allclose(rel[1], jrel[1], rtol=0, atol=1e-15)
    assert rel[2] == jrel[2] == -1 and targets[0]["ref"] == "rel"
    np.testing.assert_allclose(targets[1]["motion"][0], [0.75, 0.0, 0.02])
    np.testing.assert_array_equal(targets[1]["motion"][0], jtargets[1]["motion"][0])
    with pytest.raises(ImportError, match="robot_io"):
        PandaLfpWrapper()


def test_preprocess_real_data_helpers_equal_jax():
    from hulc2_tpu.tools import preprocess_real_data as jax_pre
    from hulc2_torch.tools import preprocess_real_data as pre

    assert (pre.MAX_REL_POS, pre.MAX_REL_ORN) == (jax_pre.MAX_REL_POS, jax_pre.MAX_REL_ORN)
    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(pre.quat_to_euler_xyz(q), jax_pre.quat_to_euler_xyz(q))
    args = (rng.standard_normal(3), rng.standard_normal(3), 0.05, rng.standard_normal(7), -1.0)
    np.testing.assert_array_equal(pre.build_robot_obs(*args), jax_pre.build_robot_obs(*args))


# ---- move_to_pt ------------------------------------------------------- #
@pytest.mark.parametrize("px,depth", [((100, 100), 1.7), ((120, 90), 1.6)])
def test_move_to_pt_equals_jax(px, depth):
    from hulc2_tpu.affordance import test_move_to_pt as jax_mtp
    from hulc2_torch.affordance import test_move_to_pt as mtp

    cam, jcam = mtp.default_static_camera(), jax_mtp.default_static_camera()
    np.testing.assert_array_equal(cam.K, jcam.K)
    np.testing.assert_array_equal(cam.T_world_cam, jcam.T_world_cam)
    (err, ok), (jerr, jok) = mtp.run(px, depth), jax_mtp.run(px, depth)
    assert ok == jok and abs(err - jerr) <= 1e-12
    assert mtp.main(["--px", str(px[0]), str(px[1]), "--depth", str(depth)]) == (0 if ok else 1)


# ---- the miner's contact check ---------------------------------------- #
class ContactEnv:
    """A simulator stand-in: the stub pybullet reports a contact of the robot
    (body 7) exactly when the reset state's tcp x is positive."""

    robot = types.SimpleNamespace(robot_uid=7)

    def __init__(self):
        self.resets = 0
        self.touching = False

    def reset(self, robot_obs, scene_obs):
        self.resets += 1
        self.touching = float(robot_obs[0]) > 0


@pytest.fixture()
def stub_pybullet(monkeypatch):
    env = ContactEnv()
    module = types.ModuleType("pybullet")
    module.getContactPoints = lambda: ([(0, 7, 3, -1, -1)] if env.touching else
                                       [(0, 2, 3, -1, -1)] if env.resets % 2 else [])
    monkeypatch.setitem(sys.modules, "pybullet", module)
    return env


def _mining_dir(root: Path, hw: int = 32, n: int = 60, seed: int = 0) -> Path:
    """One training episode with open->close gripper events at tcp x of both signs."""
    rng = np.random.default_rng(seed)
    d = root / "training"
    d.mkdir(parents=True)
    np.save(d / "ep_start_end_ids.npy", np.array([[0, n - 1]]))
    for i in range(n):
        robot = np.zeros(15, np.float32)
        robot[:3] = (rng.uniform(-0.2, 0.2), rng.uniform(-0.3, 0.05), 0.5)
        robot[-1] = -1.0 if i % 6 in (3, 4) else 1.0
        np.savez(d / f"episode_{i:07d}.npz", rgb_static=rng.integers(0, 256, (hw, hw, 3), np.uint8),
                 depth_static=np.ones((hw, hw), np.float32), robot_obs=robot,
                 scene_obs=np.zeros(24, np.float32), rel_actions=np.zeros(7, np.float32),
                 actions=np.zeros(7, np.float32))
    return root


def test_contact_check_equals_jax(tmp_path, stub_pybullet):
    """``contact_verified`` in both packages against the stub, and
    ``mine_labels(env=...)``: the events without the robot's contact are
    dropped, the rest labelled as JAX labels them."""
    from hulc2_tpu.affordance import dataset_creation as jax_mining
    from hulc2_torch.affordance import dataset_creation as mining

    frame = {"robot_obs": np.ones(15), "scene_obs": np.zeros(24)}
    for mod in (mining, jax_mining):
        assert mod.contact_verified(frame, None) is True
        assert mod.contact_verified(frame, stub_pybullet)
        assert not mod.contact_verified({**frame, "robot_obs": -np.ones(15)}, stub_pybullet)
    data = _mining_dir(tmp_path / "data")
    cam = fake_env.FakeCalvinEnv(static_hw=32, gripper_hw=32).cameras[0]
    jcam = jax_fake_env.FakeCalvinEnv(static_hw=32, gripper_hw=32).cameras[0]
    every = mining.mine_labels(data / "training", tmp_path / "all", cam)
    before = stub_pybullet.resets
    ours = mining.mine_labels(data / "training", tmp_path / "ours", cam, env=stub_pybullet)
    theirs = jax_mining.mine_labels(data / "training", tmp_path / "jax", jcam, env=stub_pybullet)
    assert ours == theirs
    assert 0 < len(ours["depths"]) < len(every["depths"])
    assert stub_pybullet.resets - before == 2 * len(mining.detect_interactions(
        [float(np.load(f)["robot_obs"][-1]) for f in sorted((data / "training").glob("*.npz"))]))


# ---- imports ----------------------------------------------------------- #
@pytest.mark.parametrize("watched,mods", [
    (("jax", "jaxlib", "flax", "optax", "hulc2_tpu"),
     ["hulc2_torch.agents.base_agent", "hulc2_torch.agents.hulc2_agent",
      "hulc2_torch.agents.real_world_agent", "hulc2_torch.envs.process_farm",
      "hulc2_torch.envs.panda_wrapper", "hulc2_torch.envs.calvin_wrapper",
      "hulc2_torch.envs.task_oracle", "hulc2_torch.evaluation.real_world_eval",
      "hulc2_torch.evaluation.interactive", "hulc2_torch.evaluation.harness",
      "hulc2_torch.affordance.test_move_to_pt", "hulc2_torch.tools.preprocess_real_data"]),
    (("torch", "jax"),
     ["hulc2_torch.envs.process_farm", "hulc2_torch.envs.calvin_wrapper",
      "hulc2_torch.envs.task_oracle", "hulc2_torch.envs.panda_wrapper",
      "hulc2_torch.agents.base_agent", "hulc2_torch.tools.preprocess_real_data",
      "hulc2_torch.affordance.test_move_to_pt"]),
], ids=["no_jax", "env_workers_no_torch"])
def test_new_modules_import_cleanly(watched, mods):
    """The new modules import nothing of JAX; what an env worker and the
    host-only tools import holds no torch either."""
    import subprocess

    repo = Path(__file__).resolve().parents[1]
    code = (f"import sys; sys.path.insert(0, {str(repo)!r}); import " + ", ".join(mods)
            + f"; bad = sorted(m for m in sys.modules if m.split('.')[0] in {watched!r});"
            " print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
