"""The count functions kept with the benchmark."""
import json

import pytest

from portbench.harness import counts
from portbench.tests.tiny import ROOT


@pytest.mark.parametrize("config, static_hw, gripper_hw, flops",
                         [("flagship", 96, 64, 3.741987e11), ("cfg_low_level", 200, 84, 8.326222e11)])
def test_train_step_flops_at_the_probe_shape(config, static_hw, gripper_hw, flops):
    """At flops_probe's shape (32 + 32 windows of 32 frames, full widths),
    counted on the meta device, the count is the one the port's probe gave
    on the card and on the CPU: 3.741987e+11 and 8.326222e+11 (the
    ``cfg_low_level`` configuration has no cell: its file is kept for this
    count)."""
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())["config"]
    dm = cfg["datamodule"]
    assert (dm["batch_size_vis"], dm["batch_size_lang"], dm["max_window_size"]) == (32, 32, 32)
    hw = {"rgb_static": (static_hw,) * 2, "rgb_gripper": (gripper_hw,) * 2}
    count = counts.train_step_flops(cfg, hw)
    assert f"{count:.6e}" == f"{flops:.6e}"


def test_shift_normalize_bytes():
    # 2048 frames of 96 x 96 into bf16: 3 bytes in, 6 out per pixel, 8 per offset pair
    assert counts.shift_normalize_bytes(2048, 96, 96, 2) == 2048 * 96 * 96 * 9 + 2048 * 8


def test_a_product_without_formula_is_refused():
    """A product op that torch's counter has no formula for (a
    matrix-vector product) makes the count raise instead of leaving it out."""
    import torch

    x = torch.randn(4, 4)
    with pytest.raises(NotImplementedError, match="mv"):
        counts.count_flops(lambda: torch.ops.aten.mv(x, x[0]), "cpu")
