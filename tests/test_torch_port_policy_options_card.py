"""The recurrent layers and carries of the policy's options on the card.

Torch only, like ``test_torch_port_kernels.py``, so it runs on a machine with
a card and no JAX: ``python -m pytest --noconftest -m cuda -s
tests/test_torch_port_policy_options_card.py``. Every test needs the card
and skips without one.

The GRU and LSTM are torch's ``nn.GRU``/``nn.LSTM`` (cuDNN on the card); they
are held against ``layers.gru_plain``/``lstm_plain``, the same cells as a
plain loop, in fp32 (TF32 off) and under the model's bf16 autocast, where
torch alone would run them in fp16 and the port's layers run them in fp32
(printed with ``-s``). A bf16 rollout's carry keeps its fp32.
"""
import pytest
import torch

import hulc2_torch.configs  # noqa: F401  (registers the config groups)
from hulc2_torch.core.config import compose
from hulc2_torch.models import layers
from hulc2_torch.models.build import build_policy
from hulc2_torch.utils.device import set_precision_flags

# the decoder's input (plan 0-1024 + gripper features 64 + goal 32) at a
# window of 32 frames and 64 windows; the posterior's at 128 features
RNN_SHAPES = {"decoder": (64, 32, 1120, 1024, 2, False),
              "bilstm_posterior": (64, 32, 128, 1024, 2, True)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_precision_flags()
    return torch.device("cuda")


def _rnn(kind: str, shape, device):
    b, s, f, h, n, bi = shape
    g = torch.Generator().manual_seed(len(kind) + f)
    if kind == "gru":
        rnn = layers.GRU(f, h, n)
    else:
        rnn = layers.LSTM(f, h, n, bidirectional=bi)
    layers.init_weights_(rnn, g)
    x = torch.randn(b, s, f, generator=g)
    d = 2 if bi else 1
    state = tuple(torch.randn(n * d, b, h, generator=g) * 0.5
                  for _ in range(2 if kind == "lstm" else 1))
    return rnn.to(device), x.to(device), tuple(t.to(device) for t in state)


def _scale(t: torch.Tensor) -> float:
    return max(t.float().abs().max().item(), 1e-3)


CASES = [("gru", "decoder"), ("lstm", "decoder"), ("lstm", "bilstm_posterior")]


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "given_state"])
@pytest.mark.parametrize("kind,where", CASES, ids=[f"{k}-{w}" for k, w in CASES])
def test_cudnn_rnn_equals_plain_loop_fp32(cuda_device, kind, where, with_state):
    """fp32, TF32 off: outputs and final states within 1e-4 of their scale."""
    shape = RNN_SHAPES[where]
    if kind == "gru" and shape[-1]:
        pytest.skip("no bidirectional GRU in the model")
    rnn, x, state = _rnn(kind, shape, cuda_device)
    st = (state if kind == "lstm" else state[0]) if with_state else None
    plain = layers.lstm_plain if kind == "lstm" else layers.gru_plain
    with torch.no_grad():
        y, h = rnn(x, st)
        y_ref, h_ref = plain(rnn, x, st)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, y_ref, atol=1e-4 * _scale(y_ref), rtol=1e-4)
    for a, b in zip(h if isinstance(h, tuple) else (h,),
                    h_ref if isinstance(h_ref, tuple) else (h_ref,)):
        torch.testing.assert_close(a, b, atol=1e-4 * _scale(b), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,where", CASES, ids=[f"{k}-{w}" for k, w in CASES])
def test_cudnn_rnn_under_bf16_autocast(cuda_device, kind, where):
    """Under the model's bf16 autocast torch would hand cuDNN's RNN fp16
    (printed here for the record); the port's layers run it in fp32:
    fp32 outputs, states and weight gradients, the outputs and states
    within 1e-4 of their scale of the fp32 plain loop."""
    rnn, x, state = _rnn(kind, RNN_SHAPES[where], cuda_device)
    st = state if kind == "lstm" else state[0]
    plain = layers.lstm_plain if kind == "lstm" else layers.gru_plain
    library = torch.nn.LSTM if kind == "lstm" else torch.nn.GRU
    with torch.no_grad():
        y_ref, h_ref = plain(rnn, x, st)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y_torch, _ = library.forward(rnn, x, st)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y, h = rnn(x, st)
    y.float().square().mean().backward()
    hs = h if isinstance(h, tuple) else (h,)
    print(f"[rnn dtype] {kind} {where} under bf16 autocast: torch's {library.__name__} runs in "
          f"{y_torch.dtype}, the port's layer in {y.dtype} (states {[t.dtype for t in hs]}, "
          f"weight grads {rnn.weight_hh_l0.grad.dtype})")
    assert y.dtype == torch.float32 and all(t.dtype == torch.float32 for t in hs)
    assert rnn.weight_hh_l0.grad.dtype == torch.float32
    torch.testing.assert_close(y.detach(), y_ref, atol=1e-4 * _scale(y_ref), rtol=1e-4)
    refs = h_ref if isinstance(h_ref, tuple) else (h_ref,)
    for a, b in zip(hs, refs):
        torch.testing.assert_close(a.detach(), b, atol=1e-4 * _scale(b), rtol=1e-4)


RECURRENT = ["model.action_decoder.rnn_model=lstm_decoder", "model/plan_recognition=bilstm",
             "model/distribution=continuous"]
NARROW = ["model.plan_proposal.hidden_size=256", "model.visual_goal.hidden_size=256",
          "model.language_goal.hidden_size=256", "model.action_decoder.hidden_size=256"]


@pytest.mark.cuda
@pytest.mark.parametrize("rnn_model", ["lstm_decoder", "gru_decoder"])
def test_bf16_rollout_carry_keeps_fp32(cuda_device, rnn_model):
    """A bf16 policy's ``policy_step`` on the card under its autocast, 6
    steps across a replan (replan_freq 4): every tensor of the carry stays
    fp32 and finite, the actions finite, and the LSTM's carry an (h, c) pair."""
    from hulc2_torch.agents.hulc2_agent import Hulc2Agent

    cfg = compose("cfg_low_level", NARROW + RECURRENT[1:] + [
        f"model.action_decoder.rnn_model={rnn_model}", "model.replan_freq=4"])
    assert cfg["model"]["compute_dtype"] == "bfloat16"
    model = build_policy(cfg["model"], gripper_hw=84, static_hw=200, seed=3).to(cuda_device).eval()
    agent = Hulc2Agent(model, cfg["datamodule"], seed=0, n_envs=4, device_render={
        "static_hw": 200, "gripper_hw": 84})
    g = torch.Generator().manual_seed(5)
    lang = torch.randn(4, 384, generator=g).numpy()
    for t in range(6):
        obs = {"robot_obs": (torch.randn(4, 15, generator=g) * 0.2).numpy(),
               "scene_obs": torch.zeros(4, 24).numpy()}
        action = agent.step_async(obs, {"lang": lang})
        if t == 2:
            agent.reset_env_slot(1)
    torch.cuda.synchronize()
    hidden = agent.carry.hidden
    tensors = hidden if isinstance(hidden, tuple) else (hidden,)
    assert len(tensors) == (2 if rnn_model == "lstm_decoder" else 1)
    assert all(h.dtype == torch.float32 and torch.isfinite(h).all() for h in tensors)
    assert torch.isfinite(action).all() and action.shape == (4, 7)
    assert agent.carry.step.tolist() == [6, 3, 6, 6]
