"""The default configuration's card-side pieces: the shift_normalize kernel
at the ``rand_shift`` shapes and the host loader's pinned ring.

Torch only, like ``test_torch_port_kernels.py``, so it runs on a machine with
a card and no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_host_loader_card.py``. The CPU file
``test_torch_port_host_loader.py`` holds the host loader against the JAX
package's; here the reference is the same loader on the CPU, which assembles
fresh numpy buffers and needs no ring. Every test needs the card and skips
without one.
"""
import time

import numpy as np
import pytest
import torch

from _torch_port_dataset import dm_cfg
from hulc2_torch import kernels
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.data.loader import DevicePrefetcher, PinnedBatch, PinnedRing
from hulc2_torch.ops import preprocess
from test_torch_port_host_loader import write_low_level_dir

# the rand_shift preset's train shapes at cfg_low_level's batch, 64 windows x 32 frames
RAND_SHIFT_SHAPES = [(2048, 200, 10), (2048, 84, 4), (2048, 200, 0), (2048, 84, 0)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_low_level_dir(tmp_path_factory.mktemp("host_card"), 200, 84)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hw,pad", RAND_SHIFT_SHAPES)
def test_kernel_matches_plain_at_rand_shift_shapes(cuda_device, n, hw, pad, out_dtype):
    """Train (pad 10 and 4) and val/eval (pad 0) at 200 and 84 px: bit for
    bit (tol 0), one launch each."""
    g = torch.Generator(device=cuda_device).manual_seed(hw + pad)
    imgs = torch.randint(0, 256, (n, hw, hw, 3), generator=g, device=cuda_device, dtype=torch.uint8)
    offsets = torch.randint(0, 2 * pad + 1, (n, 2), generator=g, device=cuda_device,
                            dtype=torch.int32)
    before = kernels.LAUNCHES["shift_normalize"]
    got = preprocess.random_shift_normalize(imgs, offsets, pad, [0.5], [0.5], out_dtype)
    assert kernels.LAUNCHES["shift_normalize"] == before + 1
    want = preprocess.shift_normalize_plain(imgs, offsets, pad, [0.5], [0.5], out_dtype)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, hw, hw, 3) and got.dtype == out_dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_ring_waits_for_the_copy_event(cuda_device):
    """A slot released with the event of a copy still in flight (queued
    behind a spin kernel on a side stream) is handed out only once that
    event has completed."""
    ring = PinnedRing({"x": ((1 << 20,), np.float32)}, 1)
    view = ring.acquire(0)
    assert ring.slots[0]["x"][0].is_pinned() and view["x"].shape == (1 << 20,)
    stream = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(1 << 28)  # ~0.1-0.2 s of spinning
        ring.batch(0)["x"].to(cuda_device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    ring.release(0, event)
    assert not event.query()
    ring.acquire(0)
    assert event.query()
    ring.close()
    with pytest.raises(RuntimeError, match="closed"):
        ring.acquire(0)


@pytest.mark.cuda
@pytest.mark.parametrize("delay_s", [0.0, 0.05], ids=["fast", "slow"])
def test_pinned_batches_equal_the_cpu_loader(cuda_device, data_dir, monkeypatch, delay_s):
    """Two epochs of the host loader on the card (pinned ring, side-stream
    copies, event waits), consumed at once or with a deliberately slow
    consumer that also keeps the step's reads on the stream: every batch
    equals the CPU loader's bit for bit, and no ring tensor is pinned again."""
    cfg = dm_cfg(data_dir, load_lang_embeddings=True, batch_vis=4, batch_lang=4, min_window=12,
                 max_window=16)
    cfg["device_store"] = False
    host = Hulc2DataModule(cfg, seed=7, device="cpu")
    card = Hulc2DataModule(cfg, seed=7, device=cuda_device)
    host.setup()
    card.setup()
    pins = []
    pin = torch.Tensor.pin_memory
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda t, *a: pins.append(t.shape) or pin(t, *a))
    loader, ref = card.fused_train_iter(), host.fused_train_iter()
    assert loader.pin_memory and not ref.pin_memory
    for epoch in range(2):
        it = DevicePrefetcher(loader, cuda_device)
        n = 0
        for got, want in zip(it, ref):
            if delay_s:
                torch.cuda._sleep(1 << 22)  # the step's device work, on the consumer's stream
                time.sleep(delay_s)
            for k, w in want.items():
                assert got[k].device.type == "cuda", k
                g = got[k].cpu().numpy()
                assert g.dtype == w.dtype and g.shape == w.shape, k
                assert (g == w).all(), f"epoch {epoch} batch {n} {k}"
            n += 1
        it.close()
        assert n == len(ref) >= 3
    assert pins == []
    batch = next(iter(loader))
    assert isinstance(batch, PinnedBatch) and all(t.is_pinned() for t in batch.values())
