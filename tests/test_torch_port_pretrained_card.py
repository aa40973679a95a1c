"""This slice's card-side pieces: the shift_normalize kernel at the real-robot
preset's shapes, the pretrained encoders on the card against the CPU, their
``compute_dtype``, the ``real_world_r3m`` transform's kernel runs and the
process loader's pinned path.

Torch only, so it runs on a machine with a card and no JAX: ``python -m
pytest --noconftest -m cuda tests/test_torch_port_pretrained_card.py``. The
CPU files ``test_torch_port_pretrained*.py`` hold the same modules against
the JAX package; here the reference is the port on the CPU. Every test needs
the card and skips without one.
"""
import glob
import time

import numpy as np
import pytest
import torch

import hulc2_torch.configs  # noqa: F401  (registers the config groups)
from hulc2_torch import kernels
from hulc2_torch.data import device_transforms as tdt
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.data.loader import DevicePrefetcher
from hulc2_torch.data.process_loader import SEGMENT_PREFIX
from hulc2_torch.models.build import build_pretrained_encoder
from hulc2_torch.models.layers import init_weights_
from hulc2_torch.ops import preprocess
from hulc2_torch.utils.device import set_precision_flags
from test_torch_port_host_loader import _host_cfg, write_low_level_dir

# real_world_r3m's uint8 runs at cfg_low_level_rw's batch of 64 windows x 32
# frames: scale_normalize(0, 1) of the 200 px static and 84 px gripper frames
RW_SHAPES = [(2048, 200), (2048, 84)]
ENCODERS = {
    "r3m": ({"_name_": "vision_r3m", "visual_features": 64, "resnet_model": "resnet18",
             "freeze_backbone": True}, 96, 3),
    "clip_rn50": ({"_name_": "vision_clip", "visual_features": 64, "model_name": "RN50",
                   "freeze_backbone": True, "tower_kwargs": {"layers": [1, 1, 1, 1], "width": 32,
                                                             "heads": 4}}, 96, 3),
    "clip_vit": ({"_name_": "vision_clip", "visual_features": 64, "model_name": "ViT-B/32",
                  "freeze_backbone": True, "tower_kwargs": {"width": 64, "layers": 2,
                                                            "heads": 2}}, 96, 3),
    "tactile": ({"_name_": "tactile_encoder", "visual_features": 64, "freeze_backbone": True},
                64, 6),
    "resnet": ({"_name_": "vision_resnet", "visual_features": 64, "freeze_backbone": False},
               96, 3),
    "resnet_aff": ({"_name_": "vision_resnet_aff", "visual_features": 64,
                    "freeze_backbone": True, "depth": 3}, 96, 3),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_precision_flags()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hw", RW_SHAPES)
def test_kernel_matches_plain_at_real_world_r3m_shapes(cuda_device, n, hw, out_dtype):
    """pad 0, mean 0, std 1: bit for bit (tol 0), one launch each."""
    g = torch.Generator(device=cuda_device).manual_seed(hw)
    imgs = torch.randint(0, 256, (n, hw, hw, 3), generator=g, device=cuda_device, dtype=torch.uint8)
    offsets = torch.zeros((n, 2), device=cuda_device, dtype=torch.int32)
    before = kernels.LAUNCHES["shift_normalize"]
    got = preprocess.random_shift_normalize(imgs, offsets, 0, [0.0], [1.0], out_dtype)
    assert kernels.LAUNCHES["shift_normalize"] == before + 1
    want = preprocess.shift_normalize_plain(imgs, offsets, 0, [0.0], [1.0], out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ENCODERS))
def test_encoder_on_the_card_equals_the_cpu(cuda_device, case):
    """fp32, TF32 off: features within 1e-4 of their scale; the head's
    gradients too, and none reach a frozen trunk."""
    cfg, hw, c = ENCODERS[case]
    enc = init_weights_(build_pretrained_encoder(cfg, hw), torch.Generator().manual_seed(0))
    x = torch.randn((8, c, hw, hw), generator=torch.Generator().manual_seed(1))
    outs = {}
    for device in ("cpu", cuda_device):
        e = enc.to(device)
        e.zero_grad(set_to_none=True)
        y = e(x.to(device))
        (y ** 2).sum().backward()
        outs[str(device)[:4]] = (y.detach().cpu(), e.fc2.weight.grad.cpu().clone(),
                                 [p.grad for n, p in e.named_parameters() if not n.startswith("fc")])
    (y0, g0, t0), (y1, g1, t1) = outs["cpu"], outs["cuda"]
    scale = max(1.0, y0.abs().max().item())
    assert (y1 - y0).abs().max().item() <= 1e-4 * scale
    assert (g1 - g0).abs().max().item() <= 1e-4 * max(1.0, g0.abs().max().item())
    assert all(g is None for g in t1) == (case != "resnet")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_dtype_sets_the_encoders_precision(cuda_device, dtype):
    """Under the model's bf16 autocast a ``float32`` encoder computes in fp32
    (its features equal the encoder's without autocast); a ``bfloat16`` one
    computes in bf16 without the model's autocast."""
    cfg, hw, c = ENCODERS["r3m"]
    enc = init_weights_(build_pretrained_encoder({**cfg, "compute_dtype": dtype}, hw),
                        torch.Generator().manual_seed(0)).to(cuda_device)
    x = torch.rand((4, c, hw, hw), device=cuda_device).to(torch.bfloat16)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        under = enc(x)
    with torch.no_grad():
        alone = enc(x if dtype == "bfloat16" else x.float())
    if dtype == "float32":
        assert under.dtype == torch.float32 and torch.equal(under, alone)
    else:
        assert alone.dtype == torch.bfloat16 and torch.equal(under, alone)


@pytest.mark.cuda
def test_real_world_r3m_transform_launches_one_kernel_per_uint8_run(cuda_device):
    """``real_world_r3m`` on a (2, 4) window of 200/84 px frames: one launch
    per camera in the train and the val pipelines, the outputs within 1e-5
    of scale of the CPU's with the same draws."""
    obs = {"rgb_obs": ["rgb_static", "rgb_gripper"], "depth_obs": [], "state_obs": ["robot_obs"],
           "actions": ["rel_actions_gripper"]}
    proprio = {"n_state_obs": 8, "keep_indices": [[0, 7], [14, 15]],
               "robot_orientation_idx": [3, 6], "normalize": True,
               "normalize_robot_orientation": True}
    g = torch.Generator().manual_seed(2)
    raw = {"rgb_static": torch.randint(0, 256, (2, 4, 200, 200, 3), generator=g, dtype=torch.uint8),
           "rgb_gripper": torch.randint(0, 256, (2, 4, 84, 84, 3), generator=g, dtype=torch.uint8),
           "robot_obs_raw": torch.randn((2, 4, 15), generator=g),
           "actions": torch.randn((2, 4, 7), generator=g)}
    for train in (True, False):
        pipelines = tdt.TRANSFORM_PRESETS["real_world_r3m"]["train" if train else "val"]
        draws = {k: tdt.op_draws(ops, (8, *raw[k].shape[2:]), g, "cpu") for k, ops in pipelines.items()}
        tf = tdt.make_batch_transform(obs, proprio, "real_world_r3m", train=train)
        want = tf(raw, None, draws)
        before = kernels.LAUNCHES["shift_normalize"]
        got = tf({k: v.to(cuda_device) for k, v in raw.items()}, None,
                 {k: {i: d.to(cuda_device) for i, d in v.items()} for k, v in draws.items()})
        assert kernels.LAUNCHES["shift_normalize"] == before + 2
        for cam, w in want["rgb_obs"].items():
            scale = max(1.0, w.abs().max().item())
            assert (got["rgb_obs"][cam].cpu() - w).abs().max().item() <= 1e-5 * scale, cam


@pytest.mark.cuda
def test_process_loader_on_the_card_gives_the_thread_loaders_batches(cuda_device, tmp_path):
    """``loader_isolation=process`` with the pinned ring: two epochs through
    the prefetcher to the card equal the thread loader's, bit for bit; an
    epoch cut short does not hold up the next; no segment outlives
    ``close``."""
    root = write_low_level_dir(tmp_path / "data", 16, 16)
    loaders, dms = {}, []
    for isolation in ("process", "none"):
        cfg = _host_cfg(root)
        cfg["loader_isolation"] = isolation
        dm = Hulc2DataModule(cfg, seed=1, device=cuda_device)
        dm.setup()
        dms.append(dm)
        loaders[isolation] = dm.fused_train_iter()
    try:
        for epoch in range(2):
            n = 0
            a = DevicePrefetcher(loaders["process"], cuda_device)
            b = DevicePrefetcher(loaders["none"], cuda_device)
            for got, want in zip(a, b):
                for k in want:
                    assert got[k].device.type == "cuda" and torch.equal(got[k], want[k]), k
                n += 1
            a.close()
            b.close()
            assert n == len(loaders["none"])
        # an epoch the consumer stops early (the trainer's limit_train_batches)
        # leaves slots of its pinned ring behind; the next epoch's ring is new
        cut = DevicePrefetcher(loaders["process"], cuda_device)
        next(cut)
        cut.close()
        t0 = time.monotonic()
        after = DevicePrefetcher(loaders["process"], cuda_device)
        for _ in range(4):
            next(after)
        after.close()
        assert time.monotonic() - t0 < 60
    finally:
        dms[0].close()
    assert not glob.glob(f"/dev/shm/{SEGMENT_PREFIX}{loaders['process'].tag}_*")


@pytest.mark.cuda
@pytest.mark.parametrize("trunk", ["resnet50", "clip_rn"])
def test_fused_trunk_equals_the_graph_path(cuda_device, trunk):
    """Without a graph the trunks' conv + BatchNorm [+ residual] + ReLU run as
    one cuDNN call: equal to the path with a graph within 1e-4 of scale in
    fp32, and within 3e-2 of scale under bf16 autocast (the fused call adds
    the bias before rounding to bf16)."""
    from hulc2_torch.models.clip_resnet import ClipModifiedResNet
    from hulc2_torch.models.resnet import ResNet

    net = (ResNet("resnet50") if trunk == "resnet50"
           else ClipModifiedResNet(96, (2, 2, 2, 2), 32, 64, 4))
    net = init_weights_(net, torch.Generator().manual_seed(3)).to(cuda_device)
    x = torch.randn((4, 3, 96, 96), device=cuda_device).contiguous(memory_format=torch.channels_last)
    last = (lambda out: out[-1]) if trunk == "resnet50" else (lambda out: out[0])
    for bf16, tol in ((False, 1e-4), (True, 3e-2)):
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
            with torch.no_grad():
                fused = last(net(x)).float()
            graph = last(net(x)).detach().float()
        assert (fused - graph).abs().max().item() <= tol * max(1.0, graph.abs().max().item())
