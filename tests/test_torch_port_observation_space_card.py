"""The observation space's card-side pieces: the shift_normalize kernel at
the new presets' shapes, and the float-frame ops and every preset's
pipelines on the card against the CPU.

Torch only, like ``test_torch_port_kernels.py``, so it runs on a machine with
a card and no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_observation_space_card.py``. The CPU file
``test_torch_port_observation_space.py`` holds the same code against the JAX
package; here the reference is the port on the CPU with the same draws.
Every test needs the card and skips without one.
"""
import numpy as np
import pytest
import torch

from hulc2_torch import kernels
from hulc2_torch.data import device_transforms as tdt
from hulc2_torch.data.statistics import DatasetStatistics
from hulc2_torch.ops import preprocess

CLIP_MEAN = [0.48145466, 0.4578275, 0.40821073]
CLIP_STD = [0.26862954, 0.26130258, 0.27577711]
# (frames, height, width, pad, mean, std): static-only 200 px, real_world's
# unshifted static, real_world_square's 150x200 frames, clip's 224 px
NEW_SHAPES = {
    "static_only_200": (2048, 200, 200, 10, [0.5], [0.5]),
    "real_world_static_200": (2048, 200, 200, 0, [0.0], [1.0]),
    "real_world_square_150x200": (2048, 150, 200, 6, [0.0], [1.0]),
    "clip_224": (2048, 224, 224, 10, CLIP_MEAN, CLIP_STD),
    "clip_val_224": (2048, 224, 224, 0, CLIP_MEAN, CLIP_STD),
}
OBS_SPACE = {"rgb_obs": ["rgb_static", "rgb_gripper"], "depth_obs": ["depth_static", "depth_gripper"],
             "state_obs": ["robot_obs", "scene_obs"], "actions": ["rel_actions"]}
ROBOT_SCENE = {"n_state_obs": 54, "keep_indices": [[0, 54]], "robot_orientation_idx": [3, 6],
               "normalize": True, "normalize_robot_orientation": True}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(NEW_SHAPES))
def test_kernel_matches_plain_at_new_shapes(cuda_device, shape, out_dtype):
    """Bit for bit (tol 0), one launch each, non-square frames included."""
    n, h, w, pad, mean, std = NEW_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(h + w + pad)
    imgs = torch.randint(0, 256, (n, h, w, 3), generator=g, device=cuda_device, dtype=torch.uint8)
    offsets = torch.randint(0, 2 * pad + 1, (n, 2), generator=g, device=cuda_device,
                            dtype=torch.int32)
    before = kernels.LAUNCHES["shift_normalize"]
    got = preprocess.random_shift_normalize(imgs, offsets, pad, mean, std, out_dtype)
    assert kernels.LAUNCHES["shift_normalize"] == before + 1
    want = preprocess.shift_normalize_plain(imgs, offsets, pad, mean, std, out_dtype)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, h, w, 3) and got.dtype == out_dtype
    assert torch.equal(got, want)


def _close_scaled(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape, what
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol, what


@pytest.mark.cuda
def test_float_frame_ops_match_cpu(cuda_device):
    """Resize (up, down, non-square), the float shift, the crop, the jitter
    and both noises on the card against the CPU, same draws: within 1e-5 of
    scale."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand((6, 96, 96, 3), generator=g) * 255
    cases = {
        "resize up": lambda t: preprocess.resize_shorter_edge(t, 200),
        "resize down": lambda t: preprocess.resize_shorter_edge(t, 64),
        "resize non-square": lambda t: preprocess.resize_shorter_edge(t[:, :80], 60),
        "shift": lambda t: preprocess.shift_from_offsets(
            torch.randint(0, 9, (6, 2), generator=torch.Generator().manual_seed(1)).to(t.device),
            t, 4),
        "crop": lambda t: preprocess.random_crop(
            t, torch.tensor([[0, 3], [5, 0], [1, 1], [8, 8], [2, 7], [4, 4]]).to(t.device), 88, 88),
        "jitter": lambda t: preprocess.color_jitter(
            t / 255, torch.tensor([0.1, 0.7, 0.2, 0.9]).to(t.device), 0.05, 0.05, 0.02, 1.0),
        "gaussian": lambda t: preprocess.add_gaussian_noise(
            t, torch.randn(t.shape, generator=torch.Generator().manual_seed(2)).to(t.device), 0.0, 0.01),
        "depth noise": lambda t: preprocess.add_depth_noise(t, torch.tensor(1.013).to(t.device)),
    }
    for name, op in cases.items():
        _close_scaled(op(x.to(cuda_device)), op(x), name)


def _raw(g: torch.Generator, sizes: dict, b: int = 4, s: int = 8) -> dict:
    raw = {cam: torch.randint(0, 256, (b, s, sizes[cam], sizes[cam], 3), generator=g,
                              dtype=torch.uint8) for cam in OBS_SPACE["rgb_obs"]}
    for cam in OBS_SPACE["depth_obs"]:
        raw[cam] = (torch.rand((b, s, sizes[cam], sizes[cam]), generator=g) * 2 + 0.5).half()
    raw["robot_obs_raw"] = torch.randn((b, s, 15), generator=g)
    raw["scene_obs"] = torch.randn((b, s, 24), generator=g)
    raw["actions"] = torch.randn((b, s, 7), generator=g)
    return raw


FRAME_SIZES = {"native": {"rgb_static": 200, "rgb_gripper": 84, "depth_static": 200,
                          "depth_gripper": 84},
               "resized": {"rgb_static": 96, "rgb_gripper": 64, "depth_static": 96,
                           "depth_gripper": 64}}


def bf16_step(pipeline: list) -> float:
    """An output's change for one bf16 step (1.0) of a pixel value below
    256 before the pipeline's normalising ops, with a margin of 1.25 for
    the colour jitter's brightness, contrast and hue (each near 1)."""
    gain = 1.0 / 255
    for op in pipeline:
        if op["op"] in ("scale_normalize", "normalize"):
            gain /= min(op["std"])
    return 1.25 * gain


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FRAME_SIZES))
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("preset", list(tdt.TRANSFORM_PRESETS))
def test_preset_pipelines_match_cpu(cuda_device, monkeypatch, preset, split, case):
    """Every preset's pipelines on the card against the CPU with the same
    draws: fp32, within 1e-5 of scale when the card's pipeline is given the
    CPU's resize values; with its own, frames resized and then shifted as
    bf16 (JAX's rounding) differ at fewer than 1e-3 of the elements, by at
    most one bf16 step of a pixel, where the two fp32 resizes straddle a
    rounding boundary. Every uint8 kernel run launched on the card, none
    taken by the plain version."""
    g = torch.Generator().manual_seed(3)
    raw = _raw(g, FRAME_SIZES[case])
    stats = DatasetStatistics(robot_obs_mean=np.zeros(15, np.float32) + 0.1,
                              robot_obs_std=np.ones(15, np.float32) * 2,
                              scene_obs_mean=np.zeros(24, np.float32) - 0.1,
                              scene_obs_std=np.ones(24, np.float32) * 3)
    tf = tdt.make_batch_transform(OBS_SPACE, ROBOT_SCENE, preset, train=split == "train",
                                  stats=stats)
    pipelines = tdt.TRANSFORM_PRESETS[preset][split]
    runs = sum(tdt.kernel_run(pipelines.get(cam, []), 0,
                              raw[cam].reshape(-1, *raw[cam].shape[2:])) is not None
               for cam in OBS_SPACE["rgb_obs"])
    draws = _draws(pipelines, raw)
    on_card = ({k: v.to(cuda_device) for k, v in raw.items()},
               {k: {i: d.to(cuda_device) for i, d in v.items()} for k, v in draws.items()})
    before = kernels.LAUNCHES["shift_normalize"]
    got = tf(on_card[0], None, draws=on_card[1])
    assert kernels.LAUNCHES["shift_normalize"] == before + runs
    want = tf(raw, None, draws=draws)
    resize = preprocess.resize_shorter_edge
    with monkeypatch.context() as m:
        m.setattr(preprocess, "resize_shorter_edge",
                  lambda x, size: resize(x.cpu(), size).to(x.device))
        same_resize = tf(on_card[0], None, draws=on_card[1])
    for group in ("rgb_obs", "depth_obs"):
        for k, w in want[group].items():
            what = f"{preset} {split} {case} {k}"
            _close_scaled(same_resize[group][k], w, what)
            g = got[group][k].float().cpu()
            off = (g - w).abs() > 1e-5 * max(1.0, w.abs().max().item())
            assert off.float().mean().item() < 1e-3, (what, off.float().mean().item())
            torch.testing.assert_close(g, w.float(), rtol=0, atol=bf16_step(pipelines.get(k, [])),
                                       msg=what)
    _close_scaled(got["robot_obs"], want["robot_obs"], "robot_obs")


def _draws(pipelines: dict, raw: dict) -> dict:
    """Seeded CPU draws for every op that draws, at the shapes the ops see."""
    g = torch.Generator().manual_seed(4)
    return {key: tdt.op_draws(ops, (raw[key].shape[0] * raw[key].shape[1], *raw[key].shape[2:4],
                                    1 if raw[key].dim() == 4 else 3), g, "cpu")
            for key, ops in pipelines.items() if key in raw}
