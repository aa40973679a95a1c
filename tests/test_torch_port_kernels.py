"""The kernel wrappers of the port: checks, launch counts, and the kernels
against their plain versions on the card.

This file imports torch and ``hulc2_torch`` only, so it also runs on a machine
with a card and no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_kernels.py``. The tests marked ``cuda`` skip without a
card.
"""
import pytest
import torch

from hulc2_torch import kernels
from hulc2_torch.ops import preprocess


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
    @pytest.mark.parametrize("pad,hw", [(4, 96), (3, 64)])
    def test_kernel_matches_plain_on_card(self, cuda_device, out_dtype, pad, hw):
        """The multiply and the add are rounded separately in the kernel, so
        it agrees with the plain version bit for bit in both output types."""
        g = torch.Generator(device=cuda_device).manual_seed(0)
        imgs = torch.randint(0, 256, (64, hw, hw, 3), generator=g, device=cuda_device,
                             dtype=torch.uint8)
        offsets = torch.randint(0, 2 * pad + 1, (64, 2), generator=g, device=cuda_device,
                                dtype=torch.int32)
        got = preprocess.random_shift_normalize(imgs, offsets, pad, [0.5], [0.5], out_dtype)
        want = preprocess.shift_normalize_plain(imgs, offsets, pad, [0.5], [0.5], out_dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=0, rtol=0)
