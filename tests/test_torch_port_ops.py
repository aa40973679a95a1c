"""The port's ops (``hulc2_torch.ops``) against the JAX package's, on the CPU in fp32.

Where the port wraps a CUDA kernel, the CPU path is the kernel's plain
version; the kernel itself is held against that plain version on the card by
``test_torch_port_kernels.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hulc2_tpu.ops import gripper_frame as jgripper
from hulc2_tpu.ops import logistic as jlogistic
from hulc2_tpu.ops import preprocess as jpre
from hulc2_tpu.ops import spatial as jspatial
from hulc2_torch.data.device_transforms import process_proprio
from hulc2_torch.ops import gripper_frame, logistic, preprocess, spatial

# fp32 elementwise math in both frameworks: agreement to a few ulps of O(1) values
ATOL_F32 = 1e-6


class TestShiftNormalize:
    @pytest.mark.parametrize("n,hw,pad", [(4, 32, 4), (6, 20, 3)])
    def test_plain_matches_pallas_interpret(self, n, hw, pad):
        """Offsets reproduced with the Pallas kernel's own draw."""
        from hulc2_tpu.ops.pallas_shift import random_shift_normalize_pallas

        imgs = np.random.default_rng(n).integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
        key = jax.random.PRNGKey(7)
        want = random_shift_normalize_pallas(key, jnp.asarray(imgs), pad, [0.5], [0.5],
                                             jnp.float32, interpret=True)
        offsets = np.array(jax.random.randint(key, (n, 2), 0, 2 * pad + 1), np.int32)
        got = preprocess.random_shift_normalize(torch.from_numpy(imgs), torch.from_numpy(offsets),
                                                pad, [0.5], [0.5], torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32, rtol=0)

    @pytest.mark.parametrize("pad,hw", [(4, 96), (3, 64)])
    def test_plain_matches_shift_from_offsets(self, pad, hw):
        rng = np.random.default_rng(pad)
        imgs = rng.integers(0, 256, (5, hw, hw, 3), dtype=np.uint8)
        offsets = rng.integers(0, 2 * pad + 1, (5, 2)).astype(np.int32)
        mean, std = [0.48, 0.45, 0.40], [0.27, 0.26, 0.28]
        want = jpre.scale_and_normalize(
            jpre.shift_from_offsets(jnp.asarray(offsets), jnp.asarray(imgs), pad), mean, std)
        got = preprocess.random_shift_normalize(torch.from_numpy(imgs), torch.from_numpy(offsets),
                                                pad, mean, std, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32, rtol=0)


def test_normalize_vector_matches_jax():
    x = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
    mean, std = [0.1, 0.2, 0.3, 0.4, 0.5], [1.0, 0.0, 2.0, 0.5, 3.0]
    np.testing.assert_allclose(preprocess.normalize_vector(torch.from_numpy(x), mean, std).numpy(),
                               np.asarray(jpre.normalize_vector(jnp.asarray(x), mean, std)),
                               atol=ATOL_F32)


def test_process_proprio_slices_keep_indices():
    from hulc2_tpu.data.device_transforms import process_proprio as jprocess
    from hulc2_tpu.data.statistics import DatasetStatistics

    cfg = {"keep_indices": [[0, 7], [14, 15]], "normalize": True}
    x = np.random.default_rng(1).standard_normal((2, 3, 15)).astype(np.float32)
    want = jprocess(jnp.asarray(x), DatasetStatistics(), cfg)
    np.testing.assert_array_equal(process_proprio(torch.from_numpy(x), cfg).numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w", [(8, 8), (5, 7)])
def test_spatial_softmax_matches_jax(h, w):
    """The port is NCHW, the JAX op NHWC; same (x_0, y_0, x_1, ...) output."""
    feats = np.random.default_rng(h).standard_normal((3, h, w, 4)).astype(np.float32) * 3
    want = jspatial.spatial_softmax(jnp.asarray(feats), jnp.asarray(1.0, jnp.float32))
    got = spatial.spatial_softmax(torch.from_numpy(feats).permute(0, 3, 1, 2), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


def test_logistic_mixture_log_prob_matches_jax():
    rng = np.random.default_rng(3)
    b, s, a, k = 3, 5, 6, 10
    logit_probs = rng.standard_normal((b, s, a, k)).astype(np.float32)
    log_scales = (rng.standard_normal((b, s, a, k)) * 2 - 3).astype(np.float32)
    means = rng.uniform(-1, 1, (b, s, a, k)).astype(np.float32)
    targets = rng.uniform(-1.05, 1.05, (b, s, a)).astype(np.float32)
    targets[0, 0, :2] = [-1.0, 1.0]  # both tail bins
    amin = -np.ones((a, 1), np.float32)
    amax = np.ones((a, 1), np.float32)
    want = jlogistic.logistic_mixture_log_prob(*map(jnp.asarray, (logit_probs, log_scales, means,
                                                                   targets, amin, amax)), 10, -7.0)
    got = logistic.logistic_mixture_log_prob(*map(torch.from_numpy, (logit_probs, log_scales, means,
                                                                      targets, amin, amax)), 10, -7.0)
    # logsumexp over 10 components of values ~ -10: a few fp32 ulps of the result
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)


def test_world_to_tcp_frame_matches_jax():
    rng = np.random.default_rng(4)
    actions = np.clip(rng.standard_normal((4, 6, 7)) * 0.5, -1, 1).astype(np.float32)
    robot_obs = rng.standard_normal((4, 6, 15)).astype(np.float32)
    want = jgripper.world_to_tcp_frame(jnp.asarray(actions), jnp.asarray(robot_obs))
    got = gripper_frame.world_to_tcp_frame(torch.from_numpy(actions), torch.from_numpy(robot_obs))
    # orientation deltas are divided by 0.01 after an atan2 of fp32 values
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-5)
