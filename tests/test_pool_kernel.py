"""The 2x2 average pool's kernel wrapper (``hulc2_torch/ops/pool.py``), its
build entry and its use in the CLIP tower (``models/clip_resnet``).

On the CPU: the plain path equals ``F.avg_pool2d(x, 2)``, the wrapper's
checks raise, the tower's pyramid is bitwise what ``F.avg_pool2d`` gives and
the build lists the kernel. On the card (``-m cuda``; torch and
``hulc2_torch`` only, so the card's machine runs them with
``python -m pytest --noconftest -m cuda tests/test_pool_kernel.py``): the
kernel bit for bit against ``F.avg_pool2d`` at the RN50 trunk's seven
shapes and an odd one, inside a replayed CUDA graph, and its launches in a
static_clip train step.
"""
import pytest
import torch
import torch.nn.functional as F

from hulc2_torch import kernels
from hulc2_torch.core import trace
from hulc2_torch.kernels import build
from hulc2_torch.models import clip_resnet
from hulc2_torch.ops import pool

# (C, H) of the seven pools of CLIP RN50 at 224x224, per frame: the stem's,
# then layer2..layer4's main path and downsample (identity)
TRUNK_SHAPES = [(64, 112), (128, 56), (256, 56), (256, 28), (512, 28), (512, 14), (1024, 14)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _nhwc(n: int, c: int, h: int, w: int, dtype=torch.float32, device="cpu",
          seed: int = 0) -> torch.Tensor:
    """(n, c, h, w) in channels_last memory, normal draws with some exact
    zeros of both signs, so the kernel's sign of a zero sum shows."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g, device=device)
    x = torch.where(x.abs() < 0.05, torch.copysign(torch.zeros_like(x), x), x)
    return x.to(dtype).permute(0, 3, 1, 2)


# ---- on the CPU --------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,c,h,w", [(2, 8, 6, 6), (1, 16, 5, 7), (3, 8, 25, 25), (2, 4, 2, 3)])
def test_plain_path_equals_avg_pool2d(dtype, n, c, h, w):
    if c * torch.tensor([], dtype=dtype).element_size() % pool.VEC_BYTES:
        c *= 2
    x = _nhwc(n, c, h, w, dtype)
    before = dict(kernels.LAUNCHES)
    got = pool.avg_pool2x2(x)
    want = F.avg_pool2d(x, 2)
    assert got.shape == (n, c, h // 2, w // 2) and got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(got.signbit(), want.signbit())
    assert kernels.LAUNCHES == before  # the CPU runs the plain version


def _bad(kind: str) -> torch.Tensor:
    x = _nhwc(2, 8, 6, 6)
    if kind == "float16":
        return x.half()
    if kind == "float64":
        return x.double()
    if kind == "nchw":
        return x.contiguous()
    if kind == "channels":  # 2 fp32 channels: 8 bytes a pixel
        return _nhwc(2, 2, 6, 6)
    if kind == "bf16_channels":  # 4 bf16 channels
        return _nhwc(2, 4, 6, 6, torch.bfloat16)
    if kind == "three_dims":
        return x[0]
    if kind == "one_row":
        return _nhwc(2, 8, 1, 6)
    if kind == "unaligned":  # a channels_last view 4 bytes into its storage
        flat = torch.zeros(1 + 2 * 6 * 6 * 8)
        x = flat[1:].view(2, 6, 6, 8).permute(0, 3, 1, 2)
        assert x.is_contiguous(memory_format=torch.channels_last)
        return x
    if kind == "grad":
        return x.requires_grad_()
    if kind == "too_many_items":  # 2^31 16-byte groups of output (32 GiB), on the meta device
        return torch.empty((2 ** 15, 8, 2 ** 10, 2 ** 10), device="meta").contiguous(
            memory_format=torch.channels_last)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["float16", "float64", "nchw", "channels", "bf16_channels",
                                  "three_dims", "one_row", "unaligned", "grad",
                                  "too_many_items"])
def test_wrapper_rejects(kind):
    x = _bad(kind)
    with pytest.raises(ValueError):
        pool.avg_pool2x2(x)


def test_no_gradient_needed_under_no_grad():
    x = _nhwc(2, 8, 6, 6).requires_grad_()
    with torch.no_grad():
        assert torch.equal(pool.avg_pool2x2(x), F.avg_pool2d(x, 2))


def test_cpu_tensors_are_not_taken(monkeypatch):
    """The model calls the kernel on the card only: a CPU tensor the kernel
    would take is left to ``F.avg_pool2d``."""
    def refuse(x):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(pool, "avg_pool2x2", refuse)
    x = _nhwc(2, 8, 6, 6)
    with torch.no_grad():
        assert torch.equal(clip_resnet.avg_pool(x, 2), F.avg_pool2d(x, 2))


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("grad", [False, True])
def test_cpu_pyramid_is_bitwise_unchanged(monkeypatch, channels_last, grad):
    """The small tower's pyramid and embedding on the CPU, fp32, NCHW and
    channels_last, with and without gradients, equal the tower's with every
    pool ``F.avg_pool2d`` (as it was before the kernel) bit for bit."""
    torch.manual_seed(0)
    tower = clip_resnet.ClipModifiedResNet(64, layers=(1, 1, 1, 1), width=8, heads=2,
                                           output_dim=32)
    with torch.no_grad():
        for p in tower.parameters():
            p.uniform_(-0.3, 0.3)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)

    def run():
        with torch.set_grad_enabled(grad):
            emb, feats = tower(x)
        return [emb.detach(), *(f.detach() for f in feats)]

    before = dict(kernels.LAUNCHES)
    got = run()
    monkeypatch.setattr(clip_resnet, "avg_pool", lambda y, k: F.avg_pool2d(y, k))
    want = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES == before


def test_build_lists_the_kernel():
    assert build.SOURCES["avg_pool2x2"] == "avg_pool2x2.cu"
    src = build.CSRC_DIR / "avg_pool2x2.cu"
    assert src.is_file() and "avg_pool2x2_launch" in src.read_text()
    assert build.library_path("avg_pool2x2").name.startswith("libavg_pool2x2-")
    assert "avg_pool2x2" in kernels.LAUNCHES and "avg_pool2x2" in kernels.REPLAYED


# ---- on the card -------------------------------------------------------------- #
def _assert_kernel_equals_aten(x: torch.Tensor) -> None:
    with torch.no_grad():
        got = pool.avg_pool2x2(x)
        want = F.avg_pool2d(x, 2)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want) and torch.equal(got.signbit(), want.signbit())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,hw", TRUNK_SHAPES + [(64, 25)])
def test_kernel_equals_avg_pool2d_on_card(cuda_device, dtype, c, hw):
    """Bit for bit, including the sign of zeros, at the trunk's seven shapes
    (8 frames) and at an odd 25x25, whose last row and column no output
    reads."""
    x = _nhwc(8, c, hw, hw, dtype, cuda_device, seed=c + hw)
    before = kernels.LAUNCHES["avg_pool2x2"]
    _assert_kernel_equals_aten(x)
    assert kernels.LAUNCHES["avg_pool2x2"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_on_a_slice_and_a_wide_frame(cuda_device, dtype):
    """A batch slice (its storage starts past the first frame), odd widths
    with more items than the grid holds threads, and 8 frames of 7x9."""
    x = _nhwc(5, 64, 41, 67, dtype, cuda_device, seed=3)[2:]
    assert x.data_ptr() % pool.VEC_BYTES == 0
    _assert_kernel_equals_aten(x)
    _assert_kernel_equals_aten(_nhwc(8, 32, 7, 9, dtype, cuda_device, seed=4))


@pytest.mark.cuda
def test_card_rejects_what_the_kernel_does_not_take(cuda_device):
    """The wrapper raises on the card; the tower sends a channels_last pool
    without gradients to it, loudly where the kernel does not take the
    dtype, and NCHW or gradient-enabled pools to ``F.avg_pool2d``."""
    x = _nhwc(2, 8, 6, 6, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError):
        pool.avg_pool2x2(x.contiguous())
    with pytest.raises(ValueError):
        pool.avg_pool2x2(x.float().requires_grad_())
    before = kernels.LAUNCHES["avg_pool2x2"]
    with torch.no_grad():
        assert torch.equal(clip_resnet.avg_pool(x, 2), F.avg_pool2d(x, 2))
        assert kernels.LAUNCHES["avg_pool2x2"] == before + 1
        assert torch.equal(clip_resnet.avg_pool(x.contiguous(), 2), F.avg_pool2d(x, 2))
        with pytest.raises(ValueError):
            clip_resnet.avg_pool(x.half(), 2)
    assert torch.equal(clip_resnet.avg_pool(x, 2), F.avg_pool2d(x, 2))  # gradients enabled
    assert kernels.LAUNCHES["avg_pool2x2"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_replayed_graph_gives_the_same_bits(cuda_device, dtype):
    """A capture records one launch; replays on new inputs in the captured
    buffer give ``F.avg_pool2d``'s bits."""
    static = _nhwc(4, 128, 56, 56, dtype, cuda_device, seed=5)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(stream):
        pool.avg_pool2x2(static)  # builds and loads before the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = kernels.LAUNCHES["avg_pool2x2"]
    with torch.no_grad(), torch.cuda.graph(graph):
        out = pool.avg_pool2x2(static)
    assert kernels.LAUNCHES["avg_pool2x2"] == before + 1
    for seed in (6, 7):
        static.copy_(_nhwc(4, 128, 56, 56, dtype, cuda_device, seed=seed))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, F.avg_pool2d(static, 2))


TINY = [  # test_torch_port_trace.TINY
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.visual_goal.hidden_size=32",
    "model.language_goal.hidden_size=32", "model.action_decoder.hidden_size=32",
    "model.language_encoder.width=32", "model.language_encoder.heads=2",
    "datamodule.batch_size_vis=2", "datamodule.batch_size_lang=2",
    "datamodule.min_window_size=4", "datamodule.max_window_size=4",
]
STATIC_CLIP = ["model/perceptual_encoder=static_clip", "datamodule.transforms=clip",
               'model.perceptual_encoder.rgb_static.tower_kwargs='
               '{"layers": [1, 1, 1, 1], "width": 8, "heads": 2, "output_dim": 32}']


@pytest.mark.cuda
def test_static_clip_step_launches_seven_pools(cuda_device):
    """An eager static_clip step runs the frozen trunk's seven pools in the
    kernel (the counter and the wrapper's count); later steps, captured and
    replayed, count the replays' launches apart; the flagship launches none."""
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.training import SyntheticRun

    run = SyntheticRun(flagship_config(TINY + STATIC_CLIP), cuda_device)
    kernels.reset_launch_counts()
    trace.enable()
    run.step(run.next_batch(), eager=True)
    torch.cuda.synchronize()
    assert trace.drain()["counters"][pool.COUNTER] == 7
    assert kernels.LAUNCHES["avg_pool2x2"] == 7

    kernels.reset_launch_counts()
    for _ in range(4):
        run.step(run.next_batch())
    torch.cuda.synchronize()
    counters = trace.drain()["counters"]
    replays = counters.get("train.graph_replays", 0)
    python_steps = counters.get("train.eager_steps", 0) + counters.get("train.graph_captures", 0)
    assert replays >= 1 and counters.get("train.graph_captures", 0) == 1
    assert counters[pool.COUNTER] == kernels.LAUNCHES["avg_pool2x2"] == 7 * python_steps
    assert kernels.REPLAYED["avg_pool2x2"] == 7 * replays
    assert kernels.launch_counts()["avg_pool2x2"] == 7 * (python_steps + replays)

    flagship = SyntheticRun(flagship_config(TINY), cuda_device)
    kernels.reset_launch_counts()
    for _ in range(3):
        flagship.step(flagship.next_batch())
    torch.cuda.synchronize()
    assert kernels.launch_counts()["avg_pool2x2"] == 0


@pytest.mark.cuda
def test_nchw_tower_on_the_card_keeps_aten_pools(cuda_device):
    """The detector's way in: NCHW-contiguous fp32 frames under no_grad.
    Its pools stay ``F.avg_pool2d``; no kernel launches."""
    tower = clip_resnet.ClipModifiedResNet(64, layers=(1, 1, 1, 1), width=8, heads=2,
                                           output_dim=32).to(cuda_device)
    before = kernels.LAUNCHES["avg_pool2x2"]
    with torch.no_grad():
        tower.pyramid(torch.randn(2, 3, 64, 64, device=cuda_device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["avg_pool2x2"] == before
