"""The real env's serial agent on the card against the same agent on the CPU.

Torch only, like ``test_torch_port_kernels.py``, so it runs on a machine with
a card and no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_real_env_card.py``. The CALVIN env is the recorded
contract in ``tests/mock_calvin_env`` (put on ``sys.path`` by a fixture).
Every test needs the card and skips without one.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hulc2_torch import kernels
from hulc2_torch.ops import preprocess

MOCK_DIR = str(Path(__file__).parent / "mock_calvin_env")
LOW_SMALL = [
    "model.plan_proposal.hidden_size=64", "model.plan_recognition.encoder_hidden_size=64",
    "model.plan_recognition.fc_hidden_size=64", "model.visual_goal.hidden_size=64",
    "model.language_goal.hidden_size=64", "model.action_decoder.hidden_size=64",
    "model.compute_dtype=\"float32\"",
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def calvin_env(monkeypatch, tmp_path):
    """A wrapped mock CALVIN env built from a dataset root's render config."""
    monkeypatch.syspath_prepend(MOCK_DIR)
    (tmp_path / ".hydra").mkdir()
    (tmp_path / ".hydra" / "merged_config.yaml").write_text("env: {}\n")
    from hulc2_torch.envs.calvin_wrapper import make_wrapped_calvin_env

    yield make_wrapped_calvin_env(tmp_path)
    for mod in [m for m in sys.modules if m.split(".")[0] == "calvin_env"]:
        del sys.modules[mod]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [200, 84])
def test_kernel_at_the_real_env_shapes(cuda_device, out_dtype, hw):
    """One frame per camera and policy step at pad 0 with the cfg_low_level
    val pipeline's statistics: the kernel bit for bit with its plain version."""
    from hulc2_torch.data.device_transforms import TRANSFORM_PRESETS

    cam = "rgb_static" if hw == 200 else "rgb_gripper"
    norm = TRANSFORM_PRESETS["rand_shift"]["val"][cam][-1]
    g = torch.Generator(device=cuda_device).manual_seed(hw)
    imgs = torch.randint(0, 256, (1, hw, hw, 3), generator=g, device=cuda_device,
                         dtype=torch.uint8)
    offsets = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    before = kernels.LAUNCHES["shift_normalize"]
    got = preprocess.random_shift_normalize(imgs, offsets, 0, norm["mean"], norm["std"], out_dtype)
    want = preprocess.shift_normalize_plain(imgs, offsets, 0, norm["mean"], norm["std"], out_dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shift_normalize"] == before + 1
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
def test_serial_agent_step_on_card_matches_cpu(cuda_device, calvin_env):
    """A small fp32 cfg_low_level policy's steps over the mock env through the
    single-env agent, 35 steps across the replan at 30, the same weights,
    observations and draws on both: actions within 1e-3 (the bound of the
    fake-env card test), two kernel launches a step on the card."""
    import hulc2_torch.configs  # noqa: F401
    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.core import config as cfg_lib
    from hulc2_torch.models.build import build_policy_for
    from hulc2_torch.models.hulc2 import PolicyDraws
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    cfg = cfg_lib.compose("cfg_low_level", LOW_SMALL)
    agents = {dev.type: Hulc2Agent(build_policy_for(cfg).to(dev).eval(), cfg["datamodule"],
                                   env=calvin_env)
              for dev in (torch.device("cpu"), cuda_device)}
    rng = np.random.default_rng(7)
    robot = np.zeros(15)
    robot[:3] = (0.02, -0.1, 0.55)
    obs = calvin_env.reset(robot_obs=robot, scene_obs=np.zeros(24))
    goal = {"lang": rng.standard_normal(384).astype(np.float32)}
    n_comp = cfg["model"]["action_decoder"]["n_mixtures"]
    before = kernels.LAUNCHES["shift_normalize"]
    for t in range(35):
        draws = (rng.gumbel(size=(1, 32, 32)), rng.uniform(1e-5, 1 - 1e-5, (1, 1, 6, n_comp)),
                 rng.uniform(1e-5, 1 - 1e-5, (1, 1, 6)))
        acts = {name: agent.step_async(obs, goal, PolicyDraws(
                    *(torch.tensor(x, dtype=torch.float32, device=agent.device) for x in draws)))
                .cpu() for name, agent in agents.items()}
        torch.testing.assert_close(acts["cuda"], acts["cpu"], atol=1e-3, rtol=0)
        obs, _, _, _ = calvin_env.step(acts["cpu"].numpy()[0])
    assert kernels.LAUNCHES["shift_normalize"] - before == 2 * 35
