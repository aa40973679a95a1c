"""The FLOP count, the CLIP text encoder and the roofline on the card.

Torch only, so it runs on a machine with a card and no JAX: ``python -m
pytest --noconftest -m cuda tests/test_torch_port_tools_card.py``. Every
test needs the card and skips without one.
"""
import json

import pytest
import torch

from hulc2_torch import kernels
from hulc2_torch.models.language import OfflineClipTextEncoder
from hulc2_torch.tools import flops_probe, roofline
from hulc2_torch.tools.profiling import profile_steps
from hulc2_torch.training import SyntheticRun

SMALL = ["model.plan_proposal.hidden_size=64", "model.plan_recognition.encoder_hidden_size=64",
         "model.plan_recognition.fc_hidden_size=64", "model.visual_goal.hidden_size=64",
         "model.language_goal.hidden_size=64", "model.action_decoder.hidden_size=64",
         "datamodule.min_window_size=4", "datamodule.max_window_size=4"]
RECURRENT = ["model.action_decoder.rnn_model=lstm_decoder", "model/plan_recognition=bilstm",
             "model/distribution=continuous"]
SENTENCES = ["open the drawer", "push the red block to the left", "lift the pink block"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], RECURRENT], ids=["rnn_decoder", "lstm_decoder"])
def test_flop_count_on_the_card_equals_the_cpu(cuda_device, extra):
    """bf16 on the card, fp32 on the CPU, cuDNN's recurrence against the
    unfused one: the same FLOPs, op for op outside the recurrences."""
    counts = {}
    for device in ("cuda", "cpu"):
        cfg = flops_probe.config_for("cfg_low_level", SMALL + extra, batch=4)
        run = SyntheticRun(cfg, device)
        counts[device] = flops_probe.count_step(run, flops_probe.host_batch(run))
    assert counts["cuda"]["flops"] == counts["cpu"]["flops"] > 0
    # the CPU runs the recurrences as matrix products, the card as cuDNN's
    rnn = {"aten._cudnn_rnn", "aten._cudnn_rnn_backward", "aten.mm", "aten.addmm"}
    for k in set(counts["cuda"]["flops_by_op"]) | set(counts["cpu"]["flops_by_op"]):
        if not extra or k not in rnn:
            assert counts["cuda"]["flops_by_op"].get(k) == counts["cpu"]["flops_by_op"].get(k), k
    assert extra == [] or "aten._cudnn_rnn_backward" in counts["cuda"]["flops_by_op"]


@pytest.mark.cuda
def test_offline_clip_encoder_card_matches_cpu(cuda_device):
    cpu = OfflineClipTextEncoder(device="cpu").embed(SENTENCES)
    card = OfflineClipTextEncoder(device="cuda").embed(SENTENCES)
    assert card.shape == cpu.shape == (3, 1024)
    assert abs(card - cpu).max() <= 1e-3 * abs(cpu).max()


@pytest.mark.cuda
def test_roofline_of_a_profiled_step(cuda_device, tmp_path):
    """The trace of two small steps: the shift kernel's rows carry their
    launch's bytes, every other row has the op that launched it."""
    cfg = flops_probe.config_for("cfg_low_level", SMALL, batch=4)
    run = SyntheticRun(cfg, "cuda")
    run.step(run.next_batch())
    kernels.reset_launch_counts()
    prof, _, _, _ = profile_steps(run, 2, eager=True)
    assert kernels.LAUNCHES["shift_normalize"] == 4
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    r = roofline.roofline(tmp_path / "t.json", 2, top=1000, hbm_gbps=3350.0)
    shift = [row for row in r["rows"] if row["family"] == "shift_normalize"]
    assert len(shift) == 2 and all(row["bytes_exact"] and row["execs_per_step"] == 1.0
                                   for row in shift)
    assert {row["bytes_per_step"] for row in shift} == {
        32 * 200 * 200 * 3 * 3 + 32 * 8, 32 * 84 * 84 * 3 * 3 + 32 * 8}  # (4 + 4) x 4 frames
    assert sum(row["op"] != "" for row in r["rows"]) >= len(r["rows"]) - 2
    json.dumps(r)
