"""The affordance package's options against the JAX package, module by module, on the CPU.

Every fuser of the registry on its own (the word fusers with a mask), the
detector's forward and loss for each sentence-level fuser, the ResNet50,
CLIP RN50 and R3M encoders frozen and trainable (outputs and where the
gradients are zero), the logistic depth head with both bounds and the
detector without one, the mask losses, the mask jitter and the dataset's
mask branch, the bf16 decoder, the predictor over sentence embeddings, the
converter's strictness and the refusal of the word fusers. Small sizes
(decoder (32, 16, 8, 8, 8), 64 px, 16-d language, batch 2); the weights are
seeded numpy values carried into the port by ``detector_flax_to_torch``,
the inputs and draws are numpy's or JAX's, handed to both sides. fp32
results are held within 1e-5 of their scale unless a test says otherwise.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port_affordance import HW, build_pair, configs, lang_input, random_variables
from hulc2_torch.affordance import dataset as port_dataset
from hulc2_torch.affordance import losses as port_losses
from hulc2_torch.affordance.depth_heads import DepthNorm
from hulc2_torch.affordance.detector import AffordancePredictor
from hulc2_torch.affordance.fusion import FUSERS
from hulc2_torch.affordance.train_affordance import build_detector
from hulc2_torch.configs.affordance import affordance_config
from hulc2_torch.core.config import options
from hulc2_torch.utils.convert import _tensors, detector_flax_to_torch, fuser

B = 2
SENTENCE_FUSERS = ["add", "mult", "max", "concat", "conv", "conv_lat", "film", "deep_conv",
                   "cross_modal_2d", "sentence_attention"]
WORD_FUSERS = ["word_attention", "mult_word", "multi_headed_word_attn"]


def close(got, want, scale_tol=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_tol * max(1.0, np.abs(want).max()))


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These small models gain nothing from torch's thread pool, and under
    pytest-xdist its threads would contend with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.mark.parametrize("key", sorted(FUSERS))
def test_fuser_equals_jax(key):
    """Each fuser alone on a 6x5 map of 8 channels; the word fusers on 5
    words with a mask that drops some."""
    from hulc2_tpu.affordance.fusion import FUSERS as JAX_FUSERS

    rng = np.random.default_rng(sum(map(ord, key)))
    x1 = rng.standard_normal((B, 6, 5, 8)).astype(np.float32)
    words = key in WORD_FUSERS
    x2 = rng.standard_normal((B, 5, 8) if words else (B, 8)).astype(np.float32)
    mask = np.array([[1, 1, 0, 1, 0], [1, 0, 0, 0, 0]], bool)
    jf = JAX_FUSERS[key]()
    kw = {"mask": jnp.asarray(mask)} if words else {}
    shapes = jax.eval_shape(lambda k: jf.init(k, jnp.asarray(x1), jnp.asarray(x2), **kw),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=1)
    want = jf.apply(variables, jnp.asarray(x1), jnp.asarray(x2), **kw)
    tf = FUSERS[key](8)
    tf.load_state_dict(_tensors(fuser(variables.get("params", {}))), strict=True)
    with torch.no_grad():
        got = tf(nchw(x1), torch.from_numpy(x2), torch.from_numpy(mask) if words else None)
    assert got.shape[1] == tf.out_channels(8)
    close(got.permute(0, 2, 3, 1).numpy(), want)


def _forward_both(jmodel, variables, tmodel, aff, seed, train=False):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)
    lang = lang_input(aff, rng, B)
    want = jax.jit(lambda v, i, l: jmodel.apply(v, i, l, train, mutable=["batch_stats"])[0])(
        variables, jnp.asarray(img), jnp.asarray(lang))
    tmodel.train(train)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img), torch.from_numpy(lang))
    return rng, img, lang, got, want


def _losses_equal(jmodel, tmodel, got, want, rng, rtol=1e-5):
    px = rng.integers(0, HW, (B, 2)).astype(np.int32)
    depth = rng.standard_normal(B).astype(np.float32)
    _, jm = jmodel.compute_loss(want, jnp.asarray(px), jnp.asarray(depth))
    _, tm = tmodel.compute_loss(got, torch.from_numpy(px), torch.from_numpy(depth))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=rtol, err_msg=k)


@pytest.mark.parametrize("fusion", SENTENCE_FUSERS)
def test_detector_with_fuser_equals_jax(fusion):
    """``rn18_pixel`` with each sentence-level fuser: logits, depth head and
    the losses, in training mode (batch statistics)."""
    jcfg, jmodel, variables, tmodel, _ = build_pair(
        "rn18_pixel", [f"aff_detection.fusion_type={fusion}"], seed=2)
    rng, _, _, got, want = _forward_both(jmodel, variables, tmodel, jcfg["aff_detection"], 3, True)
    close(got.aff_logits.numpy(), want.aff_logits)
    for g, w in zip(got.depth_pred, want.depth_pred):
        close(g.numpy(), w)
    _losses_equal(jmodel, tmodel, got, want, rng)


def _grads_both(jmodel, variables, tmodel, aff, seed):
    """(port output, JAX output, port grads by name, JAX grads in the port's
    names) of the training loss on one batch, in training mode."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)
    lang = lang_input(aff, rng, B)
    px = rng.integers(0, HW, (B, 2)).astype(np.int32)
    depth = rng.standard_normal(B).astype(np.float32)

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(img), jnp.asarray(lang), True, mutable=["batch_stats"])
        return jmodel.compute_loss(out, jnp.asarray(px), jnp.asarray(depth))[0], out

    jgrads, want = jax.jit(jax.grad(loss_fn, has_aux=True))(variables["params"])
    jgrads = detector_flax_to_torch({"params": jgrads, "batch_stats": variables["batch_stats"]},
                                    aff)
    tmodel.train()
    tmodel.zero_grad(set_to_none=True)
    got = tmodel(torch.from_numpy(img), torch.from_numpy(lang))
    tmodel.compute_loss(got, torch.from_numpy(px), torch.from_numpy(depth))[0].backward()
    return got, want, {n: p.grad for n, p in tmodel.named_parameters()}, jgrads


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "trainable"])
@pytest.mark.parametrize("group", ["rn50_pixel", "rn50_clip_pixel", "r3m_pixel"])
def test_encoder_equals_jax(group, frozen):
    """Each new encoder, frozen and trainable: the detector's logits in
    training mode, and the gradients of its training loss, zero exactly where
    JAX's are (everything of a frozen encoder, R3M's stem through layer3
    always, CLIP's unused attention pool). Where they are not, within 1e-4
    of their scale, and for the encoder within 5e-2: these random trunks
    are ill-conditioned, and the port's own fp32 gradients of ResNet50's
    stem and layer1 part from its fp64 ones by up to 4.2e-2 of their
    scale."""
    jcfg, jmodel, variables, tmodel, pcfg = build_pair(
        group, [f"aff_detection.freeze_encoder={str(frozen).lower()}"], seed=4)
    aff = jcfg["aff_detection"]
    got, want, grads, jgrads = _grads_both(jmodel, variables, tmodel, aff, 6)
    close(got.aff_logits.detach().numpy(), want.aff_logits)
    enc_zero = []
    for name, g in grads.items():
        w = jgrads[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        in_encoder = name.startswith("aff_stream.encoder.")
        if in_encoder:
            assert (np.abs(w).max() == 0) == (np.abs(g).max() == 0), name
            if np.abs(w).max() == 0:
                enc_zero.append(name)
        close(g, w, 5e-2 if in_encoder else 1e-4)
    enc = [n for n in grads if n.startswith("aff_stream.encoder.")]
    if frozen:
        assert enc_zero == enc
    elif group == "r3m_pixel":
        assert enc_zero == [n for n in enc if not n.startswith("aff_stream.encoder.layer4_")]
    elif group == "rn50_clip_pixel":
        assert enc_zero == [n for n in enc if n.startswith("aff_stream.encoder.attnpool.")]
    else:
        assert enc_zero == []


@pytest.mark.parametrize("head", ["logistic-normalized", "logistic-metric", "none"])
def test_depth_head_equals_jax(head):
    """The logistic head with (-2, 2) and (1.3, 4.5) bounds and no head: the
    outputs, the losses (no depth term without a head), and the depth sampled
    from JAX's uniforms, denormalized with normalized depth."""
    from hulc2_tpu.affordance.depth_heads import logistic_depth_sample

    dist, _, bounds = head.partition("-")
    ov = [f"aff_detection.depth_dist={'null' if dist == 'none' else dist}",
          f"aff_detection.normalize_depth={str(bounds != 'metric').lower()}"]
    jcfg, jmodel, variables, tmodel, _ = build_pair("rn18_pixel", ov, seed=7)
    rng, _, _, got, want = _forward_both(jmodel, variables, tmodel, jcfg["aff_detection"], 8)
    close(got.aff_logits.numpy(), want.aff_logits)
    _losses_equal(jmodel, tmodel, got, want, rng)
    if dist == "none":
        assert got.depth_pred is None and want.depth_pred is None
        assert tmodel.depth_stream is None and tmodel.depth_draws(B, None, "cpu") is None
        return
    for g, w in zip(got.depth_pred, want.depth_pred):
        close(g.numpy(), w)
    norm = DepthNorm(1.7, 0.3)
    key = jax.random.PRNGKey(9)
    k_sel, k_inv = jax.random.split(key)
    u_sel = jax.random.uniform(k_sel, (B, 1, 10), minval=1e-5, maxval=1 - 1e-5)
    u = jax.random.uniform(k_inv, (B, 1), minval=1e-5, maxval=1 - 1e-5)
    jnorm = norm if bounds != "metric" else None
    want_d = logistic_depth_sample(key, want.depth_pred, jnorm)
    _, got_d, _ = tmodel.predict_from_output(
        got, (torch.from_numpy(np.array(u_sel)), torch.from_numpy(np.array(u))), norm)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-6)
    assert tmodel.depth_draws(B, torch.Generator().manual_seed(0), "cpu")[0].shape == (B, 1, 10)


LOSS_CASES = ["pixel_cross_entropy", "binary_mask_bce", "binary_mask_bce_pos_weight", "dice_loss",
              "miou", "mask_criterion"]


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_function_equals_jax(case):
    from hulc2_tpu.affordance import losses as jax_losses

    rng = np.random.default_rng(LOSS_CASES.index(case))
    logits = (3 * rng.standard_normal((3, 12, 10))).astype(np.float32)
    mask = (rng.uniform(size=(3, 12, 10)) > 0.7).astype(np.float32)
    name, _, pw = case.partition("_pos_weight")
    args = {"pixel_cross_entropy": (logits.reshape(3, -1), (mask * rng.uniform(size=mask.shape))
                                    .reshape(3, -1).astype(np.float32)),
            "miou": (1 / (1 + np.exp(-logits)), mask),
            "mask_criterion": (logits.reshape(3, -1), mask)}.get(name, (logits, mask))
    kw = {"pos_weight": 3.0} if case.endswith("pos_weight") else {}
    want = getattr(jax_losses, name)(*map(jnp.asarray, args), **kw)
    got = getattr(port_losses, name)(*map(torch.from_numpy, args), **kw)
    if name == "mask_criterion":
        (want, wm), (got, gm) = want, got
        assert sorted(gm) == sorted(wm)
        for k in wm:
            np.testing.assert_allclose(gm[k].item(), float(wm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("pad", [0, 3, 8])
def test_jitter_mask_equals_jax(pad):
    """Image, mask and label shifted by the offsets JAX draws, exactly."""
    from hulc2_tpu.affordance.dataset import jitter_mask_and_image as jax_jitter

    rng = np.random.default_rng(pad)
    imgs = rng.uniform(0, 1, (5, 24, 24, 3)).astype(np.float32)
    mask = (rng.uniform(size=(5, 24, 24)) > 0.6).astype(np.float32)
    px = np.concatenate([rng.integers(0, 24, (3, 2)), [[0, 23], [23, 0]]]).astype(np.int32)
    key = jax.random.PRNGKey(pad)
    want = jax_jitter(key, jnp.asarray(imgs), jnp.asarray(mask), jnp.asarray(px), pad)
    offsets = np.asarray(jax.random.randint(key, (5, 2), 0, 2 * pad + 1), np.int32)
    got = port_dataset.jitter_mask_and_image(torch.from_numpy(imgs), torch.from_numpy(mask),
                                             torch.from_numpy(px), torch.from_numpy(offsets), pad)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("resize", [64, 32])
@pytest.mark.parametrize("stored", [True, False], ids=["stored", "synthesized"])
def test_dataset_mask_branch_equals_jax(tmp_path, stored, resize):
    """Mask items of a labelled dir, a stored mask or the synthesized disc,
    resized nearest up and down: every key and value equal to JAX's."""
    from hulc2_tpu.affordance.dataset import AffordanceDataset as JaxDataset

    rng = np.random.default_rng(int(stored))
    cam = tmp_path / "episode_0" / "data" / "static_cam"
    cam.mkdir(parents=True)
    files = []
    for i in range(3):
        item = {"frame": rng.integers(0, 256, (48, 48, 3), np.uint8),
                "centers": np.array([[0, *rng.integers(0, 48, 2)]]), "depth": 2.0 + i,
                "lang_ann": f"open the drawer {i}"}
        if stored:
            item["mask"] = (rng.uniform(size=(48, 48)) > 0.5).astype(np.uint8)
        np.savez(cam / f"frame_{i}.npz", **item)
        files.append(f"frame_{i}")
    (tmp_path / "episodes_split.json").write_text(json.dumps({
        "training": {"episode_0": {"static_cam": files}}, "validation": {},
        "norm_values": {"depth": {"static_cam": {"mean": 2.5, "std": 0.5}}}}))
    ours = port_dataset.AffordanceDataset(tmp_path, img_resize=resize, label_type="mask")
    theirs = JaxDataset(tmp_path, img_resize=resize, label_type="mask")
    for i in range(3):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b) and a["mask"].shape == (resize, resize)
        assert a["mask"].sum() > 0
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_bf16_decoder_equals_jax():
    """``compute_dtype=bfloat16``: logits within 2e-2 of their scale of JAX's
    bf16 decoder, the losses within rel 1e-2; the encoder and the parameters
    stay fp32, the logits leave fp32."""
    jcfg, jmodel, variables, tmodel, _ = build_pair(
        "rn18_pixel", ["aff_detection.compute_dtype=bfloat16"], seed=10)
    rng, _, _, got, want = _forward_both(jmodel, variables, tmodel, jcfg["aff_detection"], 11, True)
    assert got.aff_logits.dtype == torch.float32 and want.aff_logits.dtype == jnp.float32
    close(got.aff_logits.numpy(), want.aff_logits, 2e-2)
    _losses_equal(jmodel, tmodel, got, want, rng, rtol=1e-2)
    assert all(t.dtype == torch.float32 for t in tmodel.state_dict().values())


def test_sentence_predictor_equals_jax():
    """``AffordancePredictor`` of a logistic-head detector over sentence
    embeddings, captions resolved through a float ``lang_table``: pixels,
    heatmaps and the depth sampled from JAX's draws."""
    from hulc2_tpu.affordance.detector import AffordancePredictor as JaxPredictor

    jcfg, jmodel, variables, tmodel, _ = build_pair(
        "rn18_pixel", ["aff_detection.depth_dist=logistic"], seed=12)
    rng = np.random.default_rng(13)
    table = {f"caption {i}": rng.standard_normal(16).astype(np.float32) for i in range(3)}
    norm = DepthNorm(1.1, 0.2)
    jpred = JaxPredictor(jmodel, variables, norm, (HW, HW), seed=3, lang_table=table)
    tpred = AffordancePredictor(tmodel, norm, (HW, HW), seed=3, lang_table=table)
    imgs = [rng.integers(0, 256, (48, 48, 3), np.uint8) for _ in range(3)]
    k_sel, k_inv = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 1))
    draws = (torch.from_numpy(np.array(jax.random.uniform(k_sel, (4, 1, 10), minval=1e-5,
                                                            maxval=1 - 1e-5)))[:3],
             torch.from_numpy(np.array(jax.random.uniform(k_inv, (4, 1), minval=1e-5,
                                                            maxval=1 - 1e-5)))[:3])
    for got, want in zip(tpred.predict_batch(imgs, list(table), draws=draws),
                         jpred.predict_batch(imgs, list(table))):
        assert got["pixel"] == want["pixel"]
        np.testing.assert_allclose(got["softmax"], want["softmax"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-5)
    with pytest.raises(TypeError):
        tmodel(torch.zeros((1, HW, HW, 3)), torch.zeros((1, 77), dtype=torch.int64))


@pytest.mark.parametrize("group", sorted(options("aff_detection")))
def test_group_composition_equals_jax(group):
    import hulc2_tpu.configs.affordance  # noqa: F401
    from hulc2_tpu.core import config as jax_cfg_lib

    assert affordance_config([f"aff_detection={group}"]) == jax_cfg_lib.compose(
        "train_affordance", [f"aff_detection={group}"])


@pytest.mark.parametrize("fusion", WORD_FUSERS)
def test_word_fusers_refused_in_both_detectors(fusion):
    """The decoder hands every fuser the (B, E) sentence: JAX's detector fails
    on a word fuser at init, the port's refuses it by name at build."""
    from hulc2_tpu.affordance.train_affordance import build_detector as jax_build

    jcfg, pcfg = configs("rn18_pixel", [f"aff_detection.fusion_type={fusion}"])
    jmodel = jax_build(jcfg["aff_detection"])
    with pytest.raises((ValueError, IndexError)):
        jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((1, HW, HW, 3)), jnp.zeros((1, 16)),
                                             False), jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match=fusion):
        build_detector(pcfg["aff_detection"])


def test_converter_refuses_unexpected_and_missing_keys():
    jcfg, _, variables, tmodel, pcfg = build_pair("rn18_pixel", ["aff_detection.fusion_type=film"])
    aff = pcfg["aff_detection"]
    extra = jax.tree_util.tree_map(lambda x: x, variables)
    extra["params"]["aff_stream"]["decoder"]["block0"]["fuser"]["delta"] = {"scale": np.ones(2)}
    with pytest.raises(KeyError, match="delta"):
        detector_flax_to_torch(extra, aff)
    extra = jax.tree_util.tree_map(lambda x: x, variables)
    extra["params"]["lang_tower"] = {}
    with pytest.raises(KeyError, match="lang_tower"):
        detector_flax_to_torch(extra, aff)
    missing = jax.tree_util.tree_map(lambda x: x, variables)
    del missing["params"]["aff_stream"]["decoder"]["block1"]["fuser"]["beta"]
    with pytest.raises(RuntimeError, match="beta"):
        tmodel.load_state_dict(detector_flax_to_torch(missing, aff), strict=True)
