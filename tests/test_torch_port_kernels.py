"""The kernel wrappers of the port: checks, launch counts, and the kernels
against their plain versions on the card.

This file imports torch and ``hulc2_torch`` only, so it also runs on a machine
with a card and no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_kernels.py``. The tests marked ``cuda`` skip without a
card.
"""
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hulc2_torch import kernels
from hulc2_torch.ops import preprocess

# (pad, side) of every RandomShift the JAX package's transform presets use:
# rand_shift_96 (hulc2_tpu/data/device_transforms.py), rand_shift (:31, :36),
# the 224 preset (:179) and the 150 preset (:254)
PRESET_SHAPES = [(4, 96), (3, 64), (10, 200), (4, 84), (10, 224), (6, 150)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class TestShiftNormalizeWrapper:
    def test_cpu_path_counts_no_launch(self):
        imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
        before = kernels.LAUNCHES["shift_normalize"]
        preprocess.random_shift_normalize(imgs, torch.zeros((2, 2), dtype=torch.int32), 1, 0.5, 0.5)
        assert kernels.LAUNCHES["shift_normalize"] == before

    @pytest.mark.parametrize("bad", ["dtype", "offsets_dtype", "offsets_shape", "noncontig", "out_dtype"])
    def test_wrapper_rejects(self, bad):
        imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
        offsets = torch.zeros((2, 2), dtype=torch.int32)
        out_dtype = torch.bfloat16
        if bad == "dtype":
            imgs = imgs.float()
        elif bad == "offsets_dtype":
            offsets = offsets.long()
        elif bad == "offsets_shape":
            offsets = offsets[:1]
        elif bad == "noncontig":
            imgs = imgs.transpose(1, 2)
        else:
            out_dtype = torch.float16
        with pytest.raises(ValueError):
            preprocess.random_shift_normalize(imgs, offsets, 1, 0.5, 0.5, out_dtype)

    @pytest.mark.cuda
    @pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("pad,hw", PRESET_SHAPES)
    def test_kernel_matches_plain_on_card(self, cuda_device, out_dtype, pad, hw):
        """The multiply and the add are rounded separately in the kernel, so
        it agrees with the plain version bit for bit in both output types;
        at the flagship's two shapes with the main path's 2048 frames."""
        n = 2048 if (pad, hw) in PRESET_SHAPES[:2] else 64
        _assert_kernel_equals_plain(cuda_device, n, hw, hw, pad, out_dtype)

    @pytest.mark.cuda
    @pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("n", [1, 3, 2049])
    @pytest.mark.parametrize("w", [1, 17, 65])
    @pytest.mark.parametrize("pad", [0, 3])
    def test_kernel_matches_plain_at_odd_shapes(self, cuda_device, out_dtype, n, w, pad):
        """Rows of 3, 51 and 195 bytes: no source row is 16-byte aligned and
        groups of 8 outputs straddle rows, frames and the end of the tensor."""
        _assert_kernel_equals_plain(cuda_device, n, w, w, pad, out_dtype)

    @pytest.mark.cuda
    @pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("n,h,w,pad", [(3, 7, 3000, 2), (2, 3, 20000, 5), (5, 40, 17, 40)])
    def test_kernel_matches_plain_at_wide_and_tall_shapes(self, cuda_device, out_dtype, n, h, w, pad):
        """Bands of a few long rows, a row above 48 KB of shared memory, and a
        pad as large as the frame."""
        _assert_kernel_equals_plain(cuda_device, n, h, w, pad, out_dtype)

    @pytest.mark.cuda
    @pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
    def test_kernel_matches_plain_on_unaligned_images(self, cuda_device, out_dtype):
        """Images that start 867 bytes into their storage (a slice of a
        larger batch): the staged runs start off the 16-byte grid."""
        g = torch.Generator(device=cuda_device).manual_seed(1)
        imgs = torch.randint(0, 256, (6, 17, 17, 3), generator=g, device=cuda_device,
                             dtype=torch.uint8)[1:]
        offsets = torch.randint(0, 9, (5, 2), generator=g, device=cuda_device, dtype=torch.int32)
        assert imgs.data_ptr() % 16 != 0 and imgs.is_contiguous()
        got = preprocess.random_shift_normalize(imgs, offsets, 4, MEAN, STD, out_dtype)
        want = preprocess.shift_normalize_plain(imgs, offsets, 4, MEAN, STD, out_dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=0, rtol=0)

    @pytest.mark.cuda
    def test_card_path_counts_one_launch(self, cuda_device):
        imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=cuda_device)
        offsets = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
        before = kernels.LAUNCHES["shift_normalize"]
        preprocess.random_shift_normalize(imgs, offsets, 1, 0.5, 0.5)
        assert kernels.LAUNCHES["shift_normalize"] == before + 1


# per-channel statistics, so a channel mix-up in the kernel shows
MEAN, STD = [0.48, 0.45, 0.40], [0.27, 0.26, 0.28]


def _assert_kernel_equals_plain(dev, n, h, w, pad, out_dtype):
    g = torch.Generator(device=dev).manual_seed(n * 7919 + h * 31 + w)
    imgs = torch.randint(0, 256, (n, h, w, 3), generator=g, device=dev, dtype=torch.uint8)
    offsets = torch.randint(0, 2 * pad + 1, (n, 2), generator=g, device=dev, dtype=torch.int32)
    got = preprocess.random_shift_normalize(imgs, offsets, pad, MEAN, STD, out_dtype)
    want = preprocess.shift_normalize_plain(imgs, offsets, pad, MEAN, STD, out_dtype)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=0, rtol=0)


class TestShiftTiling:
    @pytest.mark.parametrize("hw,band_rows,bands", [
        (96, 96, 1), (64, 64, 1), (84, 84, 1), (200, 50, 4), (224, 45, 5), (150, 50, 3)])
    def test_preset_tilings(self, hw, band_rows, bands):
        """Whole frames at 96, 64 and 84; even bands of about 32 KB above."""
        t = preprocess.shift_tiling(2048, hw, hw)
        assert (t.band_rows, t.bands, t.blocks) == (band_rows, bands, 2048 * bands)
        assert t.stage_bytes % preprocess.ALIGN == 0
        assert band_rows * hw * 3 < t.stage_bytes <= preprocess.STAGE_BYTES + preprocess.ALIGN * 2

    def test_rejects_rows_wider_than_shared_memory(self):
        with pytest.raises(ValueError):
            preprocess.shift_tiling(1, 1, preprocess.MAX_SMEM // 3)
        with pytest.raises(ValueError):
            preprocess.shift_tiling(1, 0, 8)

    @settings(max_examples=60, deadline=None, derandomize=True)
    @given(n=st.integers(1, 5), h=st.integers(1, 256), w=st.integers(1, 256),
           pad=st.integers(0, 12), base=st.integers(0, 15))
    def test_bands_cover_rows_and_stay_in_frame(self, n, h, w, pad, base):
        """For every row offset: each output row is in exactly one band, each
        band stages every clamped source row it reads and no byte outside its
        frame, and what it writes fits the block's shared memory. ``base`` is
        the images' address modulo 16."""
        t = preprocess.shift_tiling(n, h, w)
        assert t.blocks == n * t.bands
        row_bytes = 3 * w
        for oy in range(2 * pad + 1):
            for frame in range(n):
                frame_lo = base + frame * h * row_bytes
                seen = []
                for band in range(t.bands):
                    s = preprocess.band_stage(t, h, w, pad, frame, band, oy, base)
                    assert len(s.rows) > 0
                    seen.extend(s.rows)
                    clamped = {min(max(oy + i - pad, 0), h - 1) for i in s.rows}
                    assert clamped <= set(s.src_rows)
                    assert len(s.src_rows) <= t.band_rows
                    assert s.lo == frame_lo + s.src_rows.start * row_bytes
                    assert s.hi == frame_lo + s.src_rows.stop * row_bytes
                    assert frame_lo <= s.lo < s.hi <= frame_lo + h * row_bytes
                    if len(s.bulk):
                        assert s.bulk.start % 16 == 0 and s.bulk.stop % 16 == 0
                        assert s.lo <= s.bulk.start < s.bulk.stop <= s.hi
                        assert s.bulk.start - s.lo < 16 and s.hi - s.bulk.stop < 16
                    else:
                        assert s.hi - s.lo < 32
                    # the kernel reads 4-byte words up to 4 bytes past the band's last byte
                    assert s.stage_end + 4 <= t.stage_bytes
                assert seen == list(range(h))


class TestAffineArrays:
    @pytest.mark.parametrize("mean,std", [(0.5, 0.5), ([0.5], [0.5]), (MEAN, STD)])
    def test_cached_arrays_equal_affine(self, mean, std):
        scale, shift = preprocess._affine(mean, std, 3)
        scale_c, shift_c = preprocess._affine_c(preprocess._stat_key(mean),
                                                preprocess._stat_key(std), 3)
        assert list(scale_c) == scale.tolist() and list(shift_c) == shift.tolist()
        assert preprocess._affine_c(preprocess._stat_key(mean), preprocess._stat_key(std), 3)[0] \
            is scale_c
