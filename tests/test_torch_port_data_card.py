"""The device-store loader and the prefetcher on the card, against the host plan.

Torch only, like ``test_torch_port_kernels.py``, so it runs on a machine with
a card and no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_data_card.py``. The CPU file
``test_torch_port_data.py`` holds the same loader against the JAX package's
``FusedBatchLoader``; here the reference is the port's own host assembly
(``WindowDataset.write_into``), which that file holds equal to it too. Every
test needs the card and skips without one.
"""
import numpy as np
import pytest
import torch

from _torch_port_dataset import dm_cfg, host_fused_batches, write_calvin_dir
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.data.device_transforms import process_proprio
from hulc2_torch.data.loader import DevicePrefetcher


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def calvin_dir(tmp_path_factory):
    return write_calvin_dir(tmp_path_factory.mktemp("calvin_card"), static_hw=96, gripper_hw=64)


def _dm(root, device):
    dm = Hulc2DataModule(dm_cfg(root), seed=7, device=device)
    dm.setup()
    return dm


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [False, True])
def test_device_gather_equals_host_plan(cuda_device, calvin_dir, prefetch):
    """Two epochs of device-store batches on the card, straight from the
    loader or through the prefetcher (side stream, pinned copies, event
    wait), bit for bit against the host plan."""
    host = _dm(calvin_dir, "cpu")
    dm = _dm(calvin_dir, cuda_device)
    loader = dm.fused_train_iter()
    assert dm.device_store.arrays["rgb_static"].device.type == "cuda"
    for epoch in range(2):
        batches = DevicePrefetcher(loader, cuda_device) if prefetch else loader
        n = 0
        for got, want in zip(batches, host_fused_batches(host, epoch)):
            for k, w in want.items():
                g = got[k]
                if isinstance(g, torch.Tensor):
                    assert g.device.type == "cuda" or not prefetch
                    g = g.cpu().numpy()
                assert g.dtype == w.dtype, k
                np.testing.assert_array_equal(g, w, err_msg=f"epoch {epoch} {k}")
            n += 1
        assert n == len(loader)
        if prefetch:
            batches.close()


@pytest.mark.cuda
def test_proprio_stats_on_the_card(cuda_device, calvin_dir):
    from hulc2_torch.data.statistics import load_statistics

    stats = load_statistics(calvin_dir / "training")
    cfg = dm_cfg(calvin_dir)["proprioception_dims"]
    x = torch.randn((4, 6, 15), generator=torch.Generator().manual_seed(0))
    cache = {}
    want = process_proprio(x, cfg, stats, cache)
    got = process_proprio(x.to(cuda_device), cfg, stats, cache)
    first = cache[got.device]
    process_proprio(x.to(cuda_device), cfg, stats, cache)
    assert set(cache) == {torch.device("cpu"), got.device} and cache[got.device] is first
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
