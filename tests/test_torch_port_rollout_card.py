"""The rollout path on the card against the same code on the CPU.

Torch only, like ``test_torch_port_kernels.py``, so it runs on a machine with
a card and no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_rollout_card.py``. Every test needs the card and skips
without one.
"""
import numpy as np
import pytest
import torch

from hulc2_torch import kernels
from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.envs.render_torch import make_render_obs_fn
from hulc2_torch.ops import preprocess
from hulc2_torch.tools.profile_eval import perturbed_states

SMALL = [
    "model.plan_proposal.hidden_size=64", "model.plan_recognition.encoder_hidden_size=64",
    "model.plan_recognition.fc_hidden_size=64", "model.visual_goal.hidden_size=64",
    "model.language_goal.hidden_size=64", "model.action_decoder.hidden_size=64",
    "model.language_encoder.width=32", "model.language_encoder.heads=2",
    "model.compute_dtype=\"float32\"",
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8, 32])
@pytest.mark.parametrize("hw", [96, 64])
def test_kernel_at_pad0_equals_plain(cuda_device, out_dtype, n, hw):
    """The val transform's scale/normalize: the kernel at pad 0, bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(n + hw)
    imgs = torch.randint(0, 256, (n, hw, hw, 3), generator=g, device=cuda_device, dtype=torch.uint8)
    offsets = torch.zeros((n, 2), dtype=torch.int32, device=cuda_device)
    before = kernels.LAUNCHES["shift_normalize"]
    got = preprocess.random_shift_normalize(imgs, offsets, 0, [0.5], [0.5], out_dtype)
    want = preprocess.scale_and_normalize(imgs, [0.5], [0.5]).to(out_dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shift_normalize"] == before + 1
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
def test_renderer_on_card_matches_cpu(cuda_device):
    """No pixel off by more than one LSB, fewer than 1e-4 off at all, depth
    within 1e-5 (the bounds of tests/test_render_jax.py)."""
    scenes, robots = perturbed_states(32, seed=11)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        fn = make_render_obs_fn(96, 64, device=dev)
        with torch.inference_mode():
            res = fn(torch.from_numpy(scenes).to(dev), torch.from_numpy(robots).to(dev))
        out[dev.type] = {k: v.cpu() for k, v in res.items()}
    for key in ("rgb_static", "rgb_gripper"):
        diff = (out["cpu"][key].int() - out["cuda"][key].int()).abs()
        assert (diff > 1).sum() == 0, key
        assert (diff != 0).float().mean() < 1e-4, key
    assert (out["cpu"]["depth_static"] - out["cuda"]["depth_static"]).abs().max() < 1e-5


@pytest.mark.cuda
def test_agent_policy_step_on_card_matches_cpu(cuda_device):
    """A small fp32 policy's fused render+policy step through the agent, 40
    steps across the replan at 30, env 2 restarted at step 17, the same
    weights and draws: actions within 1e-3 (fp32, TF32 off, 40 chained
    recurrent steps)."""
    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.models.build import build_policy
    from hulc2_torch.models.hulc2 import PolicyDraws
    from hulc2_torch.utils.clip_tokenizer import tokenize
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    cfg = flagship_config(SMALL)
    k, steps = 4, 40
    agents = {dev.type: Hulc2Agent(build_policy(cfg["model"], seed=5).to(dev).eval(),
                                   cfg["datamodule"], n_envs=k,
                                   device_render={"static_hw": 96, "gripper_hw": 64})
              for dev in (torch.device("cpu"), cuda_device)}
    scenes, robots = perturbed_states(steps * k, seed=12)
    lang = tokenize(["open the drawer", "turn on the led", "stack the blocks", "close the drawer"])
    rng = np.random.default_rng(13)
    for t in range(steps):
        if t == 17:
            for agent in agents.values():
                agent.reset_env_slot(2)
        obs = {"robot_obs": robots[t * k:(t + 1) * k], "scene_obs": scenes[t * k:(t + 1) * k]}
        draws = (rng.gumbel(size=(k, 32, 32)), rng.uniform(1e-5, 1 - 1e-5, (k, 1, 6, 10)),
                 rng.uniform(1e-5, 1 - 1e-5, (k, 1, 6)))
        acts = {name: agent.step_async(obs, {"lang": lang}, PolicyDraws(
                    *(torch.tensor(x, dtype=torch.float32, device=agent.device) for x in draws))).cpu()
                for name, agent in agents.items()}
        torch.testing.assert_close(acts["cuda"], acts["cpu"], atol=1e-3, rtol=0)
    assert agents["cuda"].carry.step.tolist() == [40, 40, 23, 40]
