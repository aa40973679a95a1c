"""The pretrained-architecture encoders in the port against the JAX package,
on the CPU in fp32, at small sizes (32-64 px inputs, CLIP towers narrowed
through ``tower_kwargs``).

Each module is built on both sides with the same weights: the flax
variables (params and the BatchNorms' ``batch_stats``) of the JAX module,
filled with seeded numpy values, carried into the port by ``utils/convert``.
Outputs agree to 1e-4 relative, 1e-5 of their scale absolute: the ResNet
pyramids of resnet18/34/50 (``models/resnet.py``), CLIP's ModifiedResNet and
ViT, the five encoders of ``models/pretrained_vision.py``, ``ClipProj`` and
the tactile slot of ``ConcatEncoders``. The upstream-name loaders are held
against the JAX converters on one random upstream state_dict each, and
``evaluation/loading.load_policy_from_torch_ckpt`` against JAX's on a
Lightning-shaped checkpoint.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hulc2_tpu.configs  # noqa: F401  (registers the JAX groups)
import hulc2_torch.configs  # noqa: F401  (registers the port's groups)
from hulc2_torch.models.build import build_pretrained_encoder
from hulc2_torch.utils import convert as tconv

RTOL, ATOL_SCALE = 1e-4, 1e-5


def random_variables(shapes, seed: int):
    """numpy values for flax variables: params U(+-1/sqrt(fan_in)) kernels,
    scales near 1, small biases and embeddings; BatchNorm means near 0 and
    variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(getattr(k, "key", k)) for k in path]
        name, shape = names[-1], leaf.shape
        if names[0] == "batch_stats":
            return (rng.uniform(0.5, 1.5, shape) if name == "var"
                    else rng.uniform(-0.1, 0.1, shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.uniform(-0.1, 0.1, shape)).astype(np.float32)
        if name == "kernel":
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
        elif name == "bias":
            bound = 0.1
        else:  # embeddings, positional tables, projections
            bound = 1 / np.sqrt(shape[0]) if name == "proj" else 0.5
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flax_init(module, x, seed: int):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return random_variables(shapes, seed)


def close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_SCALE * max(1.0, float(np.abs(want).max())), err_msg=what)


def nhwc_images(seed: int, n: int, hw: int, c: int = 3, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((n, hw, hw, c)) * scale).astype(np.float32)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def load(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()},
                           strict=True)
    return module.eval()


# ---- the trunks ---------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50"])
def test_resnet_pyramid_equals_jax(arch):
    """Every level of [input, stem, layer1..layer4] and ``out_channels``;
    ``frozen_stages`` detaches the levels it names."""
    from hulc2_tpu.models.resnet import ResNet as JResNet

    from hulc2_torch.models.resnet import ResNet

    x = nhwc_images(0, 2, 40)
    jm = JResNet(arch)
    var = flax_init(jm, x, 1)
    want = jm.apply(var, jnp.asarray(x))
    tm = load(ResNet(arch), tconv.resnet(var["params"], var["batch_stats"]))
    assert tm.out_channels == jm.out_channels
    got = tm(nchw(x))
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        close(g.permute(0, 2, 3, 1), w, f"{arch} level {i}")
    frozen = load(ResNet(arch, frozen_stages=2), tconv.resnet(var["params"], var["batch_stats"]))
    feats = frozen(nchw(x))
    assert not feats[1].requires_grad and not feats[2].requires_grad and feats[3].requires_grad


def test_clip_modified_resnet_equals_jax():
    """A narrow RN50-shaped tower (one block per stage, width 16): the
    pyramid and the attention pool's embedding; the positional table sized
    from the input (64 px -> 2x2 tokens + 1), a wrong size refused."""
    from hulc2_tpu.models.clip_resnet import ClipModifiedResNet as JClipRN

    from hulc2_torch.models.clip_resnet import ClipModifiedResNet, attnpool_grid

    kw = dict(layers=(1, 2, 1, 1), width=16, output_dim=24, heads=4)
    x = nhwc_images(2, 3, 64)
    jm = JClipRN(**kw)
    var = flax_init(jm, x, 3)
    emb, feats = jm.apply(var, jnp.asarray(x))
    assert attnpool_grid(64) == 4 and attnpool_grid(224) == 49
    tm = load(ClipModifiedResNet(64, **kw), tconv.clip_resnet(var["params"], var["batch_stats"]))
    got_emb, got_feats = tm(nchw(x))
    close(got_emb, emb, "embedding")
    for i, (g, w) in enumerate(zip(got_feats, feats)):
        close(g.permute(0, 2, 3, 1), w, f"level {i}")
    with pytest.raises(ValueError, match="input size"):
        tm(nchw(nhwc_images(2, 1, 96)))


def test_clip_vision_transformer_equals_jax():
    from hulc2_tpu.models.clip_vit import ClipVisionTransformer as JViT

    from hulc2_torch.models.clip_vit import ClipVisionTransformer

    kw = dict(patch_size=8, width=32, layers=2, heads=2, output_dim=24, input_resolution=32)
    x = nhwc_images(4, 3, 32)
    jm = JViT(**kw)
    var = flax_init(jm, x, 5)
    tm = load(ClipVisionTransformer(**kw), tconv.clip_vit(var["params"]))
    close(tm(nchw(x)), jm.apply(var, jnp.asarray(x)), "ViT embedding")


# ---- the encoders --------------------------------------------------------- #
ENCODERS = {
    "r3m": ({"_name_": "vision_r3m", "visual_features": 16, "resnet_model": "resnet18",
             "freeze_backbone": True}, 48, 3),
    "r3m_resnet50": ({"_name_": "vision_r3m", "visual_features": 16, "resnet_model": "resnet50",
                      "freeze_backbone": True}, 32, 3),
    "clip_rn50": ({"_name_": "vision_clip", "visual_features": 16, "model_name": "RN50",
                   "freeze_backbone": True, "tower_kwargs": {"layers": [1, 1, 1, 1], "width": 16,
                                                             "output_dim": 1024, "heads": 4}},
                  64, 3),
    "clip_vit": ({"_name_": "vision_clip", "visual_features": 16, "model_name": "ViT-B/32",
                  "freeze_backbone": True, "tower_kwargs": {"patch_size": 8, "width": 32,
                                                            "layers": 1, "heads": 2,
                                                            "output_dim": 24}}, 32, 3),
    "tactile": ({"_name_": "tactile_encoder", "visual_features": 16, "freeze_backbone": True},
                32, 6),
    "resnet": ({"_name_": "vision_resnet", "visual_features": 16, "freeze_backbone": False},
               40, 3),
    "resnet_aff": ({"_name_": "vision_resnet_aff", "visual_features": 16,
                    "freeze_backbone": True, "depth": 3}, 40, 3),
}


def jax_encoder(cfg: dict):
    from hulc2_tpu.core import config as jcfg
    import hulc2_tpu.models.build  # noqa: F401  (registers the factories)

    return jcfg.instantiate(dict(cfg))


def build_encoder_pair(case: str, seed: int = 0):
    """(JAX module, its variables, the port's module with the same weights,
    NHWC input) of one ``ENCODERS`` case."""
    cfg, hw, c = ENCODERS[case]
    x = nhwc_images(seed, 4, hw, c)
    jm = jax_encoder(cfg)
    var = flax_init(jm, x, seed + 1)
    tm = build_pretrained_encoder(cfg, hw)
    load(tm, tconv.pretrained_encoder(cfg["_name_"], var["params"], var.get("batch_stats", {})))
    return jm, var, tm, x


@pytest.mark.parametrize("case", list(ENCODERS))
def test_pretrained_encoder_equals_jax(case):
    """The encoder's features, and gradients only where JAX's flow: into
    the FC head always, into the trunk only when it is not frozen (the
    frozen trunk runs without a graph)."""
    jm, var, tm, x = build_encoder_pair(case)
    want = jm.apply(var, jnp.asarray(x))
    got = tm(nchw(x))
    close(got, want, case)
    got.sum().backward()
    trunk_grads = [p.grad for n, p in tm.named_parameters() if not n.startswith("fc")]
    assert all(p.grad is not None for n, p in tm.named_parameters() if n.startswith("fc"))
    trains_trunk = case == "resnet"
    assert any(g is not None for g in trunk_grads) == trains_trunk
    if trains_trunk:  # the trunk's gradient as JAX's
        jgrad = jax.jit(jax.grad(lambda p: jm.apply({**var, "params": p}, jnp.asarray(x)).sum()))(
            var["params"])
        conv1 = np.asarray(jgrad["resnet"]["conv1"]["kernel"]).transpose(3, 2, 0, 1)
        close(tm.resnet.conv1.weight.grad, conv1, "trunk conv1 grad")


def test_resnet_aff_flattens_nhwc():
    """``vision_resnet_aff`` flattens the stride-8 map in NHWC order, as the
    JAX module does: an NCHW flatten into the carried fc1 weights gives
    other features."""
    jm, var, tm, x = build_encoder_pair("resnet_aff", seed=3)
    y = tm.resnet(nchw(x), 3)[3]
    assert y.shape[1:] == (128, 5, 5) and tm.fc1.in_features == 128 * 25
    wrong = tm.fc3(torch.relu(tm.fc2(torch.relu(tm.fc1(y.flatten(1))))))
    want = np.asarray(jm.apply(var, jnp.asarray(x)))
    assert np.abs(wrong.detach().numpy() - want).max() > 1e-3
    close(tm(nchw(x)), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_dtype_is_accepted_as_jax_accepts_it(dtype):
    cfg = {**ENCODERS["r3m"][0], "compute_dtype": dtype}
    enc = build_pretrained_encoder(cfg, 48)
    # the reference's input_shape goes to vision_resnet_aff alone, as in JAX
    aff = {**ENCODERS["resnet_aff"][0], "compute_dtype": dtype, "input_shape": [40, 40, 3]}
    assert build_pretrained_encoder(aff, 40).fc1.in_features == 128 * 5 * 5
    assert jax_encoder(aff).depth == 3
    assert enc.compute_dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    assert jax_encoder(cfg).dtype == {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    # on the CPU the encoder computes in the input's dtype, as the model does
    assert enc(torch.zeros(2, 3, 48, 48)).dtype == torch.float32


def test_clip_proj_equals_jax():
    from hulc2_tpu.models.aux_nets import ClipProj as JClipProj

    from hulc2_torch.models.aux_nets import ClipProj

    x = np.random.default_rng(0).standard_normal((5, 24)).astype(np.float32)
    jm = JClipProj(output_dim=12)
    var = flax_init(jm, x, 1)
    tm = load(ClipProj(24, 12), {f"proj.{k}": v for k, v in tconv.linear(var["params"]["proj"]).items()})
    close(tm(torch.from_numpy(x)), jm.apply(var, jnp.asarray(x)))


def test_tactile_slot_follows_jax_order():
    """``ConcatEncoders`` with a static encoder, the tactile one and the
    proprio slice: rgb_static ++ tactile ++ proprio, as JAX concatenates."""
    from hulc2_tpu.models.perceptual import ConcatEncoders as JConcat

    from hulc2_torch.models.perceptual import ConcatEncoders

    jt, tvar, tt, _ = build_encoder_pair("tactile", seed=5)
    js, svar, ts, _ = build_encoder_pair("resnet", seed=6)
    rng = np.random.default_rng(7)
    rgb = {"rgb_static": rng.standard_normal((2, 3, 40, 40, 3)).astype(np.float32),
           "rgb_tactile": rng.standard_normal((2, 3, 32, 32, 6)).astype(np.float32)}
    robot = rng.standard_normal((2, 3, 8)).astype(np.float32)
    jc = JConcat(rgb_static=js, tactile=jt, proprio_dim=8)
    var = {"params": {"rgb_static": svar["params"], "tactile": tvar["params"]},
           "batch_stats": {"rgb_static": svar["batch_stats"], "tactile": tvar["batch_stats"]}}
    want = jc.apply(var, {k: jnp.asarray(v) for k, v in rgb.items()}, {}, jnp.asarray(robot))
    tc = ConcatEncoders(ts, tactile=tt, proprio_dim=8)
    got = tc({k: torch.from_numpy(v) for k, v in rgb.items()}, {}, torch.from_numpy(robot))
    assert got.shape == (2, 3, 16 + 16 + 8)
    close(got, want)


# ---- the upstream-name loaders -------------------------------------------- #
def _upstream_resnet_sd(arch: str, seed: int, prefix: str = "") -> dict:
    """A random torchvision-named ResNet state_dict (with the ``fc`` head and
    ``num_batches_tracked`` a real one carries)."""
    from hulc2_torch.models.resnet import ResNet

    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in ResNet(arch).state_dict().items():
        up = name.replace("ds_conv", "downsample.0").replace("ds_bn", "downsample.1")
        up = up.replace("_", ".", 1) if up.startswith("layer") else up
        sd[prefix + up] = torch.from_numpy(
            (rng.uniform(0.5, 1.5, t.shape) if name.endswith("running_var")
             else rng.uniform(-0.3, 0.3, t.shape)).astype(np.float32))
        if name.endswith("running_var"):
            sd[prefix + up.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    sd[prefix + "fc.weight"] = torch.zeros(10, ResNet(arch).out_channels[-1])
    sd[prefix + "fc.bias"] = torch.zeros(10)
    return sd


def _equal_sd(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_torchvision_loader_equals_jax_converter(arch):
    from hulc2_tpu.models.resnet import convert_torchvision_resnet as jconvert

    from hulc2_torch.models.resnet import ResNet

    sd = _upstream_resnet_sd(arch, 0)
    got = tconv.convert_torchvision_resnet(sd, arch)
    jvar = jconvert({k: v.numpy() for k, v in sd.items()}, arch)
    _equal_sd(got, tconv.resnet(jvar["params"], jvar["batch_stats"]))
    ResNet(arch).load_state_dict(got, strict=True)


@pytest.mark.parametrize("prefix", ["module.convnet.", "convnet."])
def test_r3m_loader_equals_jax_converter(prefix):
    from hulc2_tpu.models.pretrained_vision import convert_r3m_checkpoint as jconvert

    sd = _upstream_resnet_sd("resnet18", 1, prefix)
    sd["module.lang_enc.weight" if prefix.startswith("module") else "lang_enc.weight"] = torch.zeros(3)
    got = tconv.convert_r3m_checkpoint(sd)
    jvar = jconvert({k: v.numpy() for k, v in sd.items()})
    _equal_sd(got, tconv.resnet(jvar["params"], jvar["batch_stats"]))
    enc = build_pretrained_encoder(ENCODERS["r3m"][0], 48)
    enc.r3m.load_state_dict(got, strict=True)
    with pytest.raises(KeyError, match="convnet"):
        tconv.convert_r3m_checkpoint({"fc.weight": torch.zeros(1)})


def _upstream_clip_rn_sd(layers, width: int, heads_dim: int, out: int, grid: int, seed: int):
    """A random OpenAI-named ModifiedResNet state_dict under ``visual.``."""
    from hulc2_torch.models.clip_resnet import ClipModifiedResNet

    rng = np.random.default_rng(seed)
    m = ClipModifiedResNet(int(np.sqrt(grid)) * 32, layers, width, out, heads_dim)
    sd = {}
    for name, t in m.state_dict().items():
        up = name.replace("ds_conv", "downsample.0").replace("ds_bn", "downsample.1")
        up = up.replace("_", ".", 1) if up.startswith("layer") else up
        val = rng.uniform(0.5, 1.5, t.shape) if "running_var" in name else rng.uniform(-0.3, 0.3, t.shape)
        sd["visual." + up] = torch.from_numpy(val.astype(np.float32))
    sd["transformer.resblocks.0.ln_1.weight"] = torch.zeros(4)  # the text side is ignored
    return sd


def test_clip_visual_loader_equals_jax_converter():
    from hulc2_tpu.models.clip_resnet import convert_clip_visual as jconvert

    from hulc2_torch.models.clip_resnet import ClipModifiedResNet

    layers = (1, 2, 1, 1)
    sd = _upstream_clip_rn_sd(layers, 16, 4, 24, 4, 2)
    assert "visual.layer2.0.downsample.0.weight" in sd and "visual.attnpool.q_proj.weight" in sd
    got = tconv.convert_clip_visual(sd, layers)
    jvar = jconvert({k: v.numpy() for k, v in sd.items()}, layers)
    _equal_sd(got, tconv.clip_resnet(jvar["params"], jvar["batch_stats"]))
    ClipModifiedResNet(64, layers, 16, 24, 4).load_state_dict(got, strict=True)


def test_clip_vit_loader_equals_jax_converter():
    from hulc2_tpu.models.clip_vit import convert_clip_vit as jconvert

    from hulc2_torch.models.clip_vit import ClipVisionTransformer

    kw = dict(patch_size=8, width=64, layers=2, heads=1, output_dim=24, input_resolution=32)
    rng = np.random.default_rng(3)
    sd = {"visual." + k: torch.from_numpy(rng.uniform(-0.3, 0.3, t.shape).astype(np.float32))
          for k, t in ClipVisionTransformer(**kw).state_dict().items()}
    got, got_kw = tconv.convert_clip_vit(sd)
    jparams, jkw = jconvert(sd)
    assert got_kw == jkw == kw
    _equal_sd(got, tconv.clip_vit(jparams))
    ClipVisionTransformer(**got_kw).load_state_dict(got, strict=True)
