"""JAX flax params -> the port's ``state_dict`` (the inverse of ``hulc2_tpu/utils/convert.py``).

``flax_to_torch(params, model_cfg)`` takes the flax param tree of the JAX
``Hulc2`` as numpy arrays and returns tensors under the port's names, which
are the reference's (``perceptual_encoder.rgb_static_encoder.conv_model.0``,
``plan_recognition.transformer_encoder.layers.{i}``,
``action_decoder.rnn.weight_ih_l{k}``, ...) and OpenAI CLIP's for
``lang_net``. Layout rules, flax -> torch:

- Dense kernel (in, out) -> Linear weight (out, in);
- Conv kernel (kh, kw, in, out) -> (out, in, kh, kw); the stem kernels are
  stored space-to-depth packed, (2, 2, 16 C, out), and are unpacked to 8x8;
- LayerNorm scale/bias -> weight/bias;
- RNN, GRU and LSTM ``w_ih_l{n}[_reverse]``/``w_hh_...`` (in, G H) ->
  ``weight_ih_l{n}[_reverse]``/``weight_hh_...`` (G H, in), the gates in
  the same order (r, z, n and i, f, g, o are torch's);
- CLIP's separate q/k/v kernels -> one packed ``in_proj_weight`` (3C, C).

The pretrained encoders (R3M, CLIP RN50/ViT, tactile, ``vision_resnet``,
``vision_resnet_aff``) carry their BatchNorm statistics in the variables'
``batch_stats`` collection: ``TorchBatchNorm`` and flax ``nn.BatchNorm``
scale/bias/mean/var -> weight/bias/running_mean/running_var.
``detector_flax_to_torch(variables, aff_cfg)`` does the same for the JAX
``AffordanceDetector``'s {"params", "batch_stats"}, the tower through the
CLIP mapping.

The upstream checkpoints' loaders (counterparts of the JAX converters) take
a torch state_dict under its upstream names into the port's modules:
``convert_torchvision_resnet`` (torchvision's ``layer1.0.downsample.0``
-> ``layer1_0.ds_conv``), ``convert_r3m_checkpoint`` (R3M's ``convnet.*``),
``convert_clip_visual`` (OpenAI CLIP's ModifiedResNet under ``visual.``)
and ``convert_clip_vit`` (its ViT, whose names the port keeps).
``load_lightning_checkpoint`` reads a reference trainer's ``.ckpt``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

SD = Dict[str, np.ndarray]


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _tensors(sd: SD) -> Dict[str, torch.Tensor]:
    """Writable, contiguous copies (jax arrays come as read-only numpy)."""
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def _prefixed(prefix: str, sd: SD) -> SD:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def dense(p: Mapping) -> SD:
    """flax nn.Dense params {kernel, bias} -> Linear {weight, bias}."""
    return {"weight": _f32(p["kernel"]).T, "bias": _f32(p["bias"])}


def linear(p: Mapping) -> SD:
    """The JAX package's Dense wrapper ({"linear": {...}})."""
    return dense(p["linear"])


def layer_norm(p: Mapping) -> SD:
    return {"weight": _f32(p["scale"]), "bias": _f32(p["bias"])}


def unpack_stem_kernel(kernel: np.ndarray, block: int = 4) -> np.ndarray:
    """(kh/b, kw/b, b*b*C, O) space-to-depth packed kernel -> (kh, kw, C, O);
    the inverse of ``hulc2_tpu/ops/space_to_depth.py:pack_conv_kernel``
    (packed channel = dy*b*C + dx*C + c)."""
    ph, pw, bbc, o = kernel.shape
    c = bbc // (block * block)
    k = _f32(kernel).reshape(ph, pw, block, block, c, o)  # (ky, kx, dy, dx, c, o)
    return k.transpose(0, 2, 1, 3, 4, 5).reshape(ph * block, pw * block, c, o)


def conv(p: Mapping, stem: bool = False) -> SD:
    """The JAX package's Conv wrapper -> Conv2d {weight, bias}."""
    kernel = _f32(p["conv"]["kernel"])
    if stem and kernel.shape[:2] == (2, 2):
        kernel = unpack_stem_kernel(kernel)
    return {"weight": kernel.transpose(3, 2, 0, 1), "bias": _f32(p["conv"]["bias"])}


def vision_network(p: Mapping) -> SD:
    out = {
        **_prefixed("conv_model.0", conv(p["conv0"], stem=True)),
        **_prefixed("conv_model.2", conv(p["conv1"])),
        **_prefixed("conv_model.4", conv(p["conv2"])),
        **vision_head(p),
    }
    if "temperature" in p:  # the learnable spatial-softmax temperature
        out["temperature"] = _f32(p["temperature"])
    return out


def vision_head(p: Mapping) -> SD:
    return {**_prefixed("fc1.0", linear(p["fc1"])), **_prefixed("fc2", linear(p["fc2"])),
            **_prefixed("ln", layer_norm(p["ln"]))}


def conv_trunk(trunk: Mapping) -> SD:
    """A trunk's ``conv{i}`` and ``fc`` -> ``conv_model.{2 i}`` and the
    linear after the flatten (7 for nature_cnn and cnn_3_layers, 9 for
    cnn_4_layers). Only the nature stem's 8x8 kernel is stored packed."""
    n = sum(1 for k in trunk if k.startswith("conv"))
    out: SD = {}
    for i in range(n):
        out.update(_prefixed(f"conv_model.{2 * i}", conv(trunk[f"conv{i}"], stem=i == 0)))
    out.update(_prefixed(f"conv_model.{2 * n + 1}", linear(trunk["fc"])))
    return out


def vision_network_gripper(p: Mapping) -> SD:
    """``VisionNetworkGripper`` of any trunk, and ``VisionConv``."""
    return {**conv_trunk(p["trunk"]), **vision_head(p)}


def mha(p: Mapping) -> SD:
    return {
        "in_proj_weight": _f32(p["in_proj"]["kernel"]).T,
        "in_proj_bias": _f32(p["in_proj"]["bias"]),
        **_prefixed("out_proj", dense(p["out_proj"])),
    }


def transformer_encoder_layer(p: Mapping) -> SD:
    return {
        **_prefixed("self_attn", mha(p["self_attn"])),
        **_prefixed("linear1", linear(p["ff1"])),
        **_prefixed("linear2", linear(p["ff2"])),
        **_prefixed("norm1", layer_norm(p["norm1"])),
        **_prefixed("norm2", layer_norm(p["norm2"])),
    }


def plan_proposal(p: Mapping) -> SD:
    out: SD = {}
    for i in range(4):
        out.update(_prefixed(f"fc_model.{2 * i}", linear(p[f"fc{i}"])))
    out.update(_prefixed("fc_state.0", linear(p["fc_state"])))
    return out


def plan_recognition_transformer(p: Mapping, num_layers: int) -> SD:
    out = {"position_embeddings.weight": _f32(p["position_embeddings"]),
           **_prefixed("fc", linear(p["fc"])),
           **_prefixed("fc_state.0", linear(p["fc_state"]))}
    for i in range(num_layers):
        out.update(_prefixed(f"transformer_encoder.layers.{i}",
                             transformer_encoder_layer(p[f"layer{i}"])))
    for ln in ("pos_ln", "final_ln"):
        if ln in p:
            out.update(_prefixed(ln, layer_norm(p[ln])))
    return out


def rnn_weights(p: Mapping) -> SD:
    """A stacked RNN/GRU/LSTM's ``{w,b}_{ih,hh}_l{n}[_reverse]`` -> torch's names."""
    out: SD = {}
    for name, v in p.items():
        kind, rest = name[:4], name[4:]  # "w_ih", "_l0_reverse"
        torch_kind = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
                      "b_hh": "bias_hh"}[kind]
        out[torch_kind + rest] = _f32(v).T if kind.startswith("w") else _f32(v)
    return out


def plan_recognition(p: Mapping, pr_cfg: dict) -> SD:
    kind = pr_cfg.get("kind", "transformers")
    if kind == "transformers":
        return plan_recognition_transformer(p, pr_cfg["num_layers"])
    out = _prefixed("fc_state.0", linear(p["fc_state"]))
    if kind == "bilstm":
        out.update(_prefixed("bilstm", rnn_weights(p["bilstm"])))
    else:
        for name, sub in p.items():
            if name.startswith(("fwd", "bwd")):
                out.update(_prefixed(name, rnn_weights(sub)))
    return out


def goal_encoder(p: Mapping, has_dropout_front: bool) -> SD:
    idx = (1, 3, 5) if has_dropout_front else (0, 2, 4)
    out = {}
    for i, j in enumerate(idx):
        out.update(_prefixed(f"mlp.{j}", linear(p[f"fc{i}"])))
    out.update(_prefixed("ln", layer_norm(p["ln"])))
    return out


def action_decoder(p: Mapping) -> SD:
    """The logistic decoder (its gripper head only with a discrete gripper)
    or the deterministic one, over a stacked RNN, GRU, LSTM or the MLP
    (``fc{i}`` -> ``rnn.{2 i}``)."""
    rnn = p["rnn"]
    if "fc0" in rnn:
        out = {f"rnn.{2 * i}.{k}": v for i in range(3) for k, v in linear(rnn[f"fc{i}"]).items()}
    else:
        out = _prefixed("rnn", rnn_weights(rnn))
    for head in ("prob_fc", "mean_fc", "log_scale_fc", "gripper_fc", "actions"):
        if head in p:
            out.update(_prefixed(head, linear(p[head])))
    return out


def two_layer(p: Mapping) -> SD:
    return {**_prefixed("fc0", linear(p["fc0"])), **_prefixed("fc1", linear(p["fc1"]))}


def proj_vis_lang(p: Mapping) -> SD:
    return {
        **_prefixed("mlp_im.0", linear(p["im_fc0"])),
        **_prefixed("mlp_im.2", linear(p["im_fc1"])),
        **_prefixed("mlp_lang.0", linear(p["lang_fc0"])),
        **_prefixed("mlp_lang.2", linear(p["lang_fc1"])),
    }


def clip_resblocks(p: Mapping, layers: int) -> SD:
    """The JAX towers' ``resblock_{i}`` -> ``transformer.resblocks.{i}``."""
    out: SD = {}
    for i in range(layers):
        blk, attn = p[f"resblock_{i}"], p[f"resblock_{i}"]["attn"]
        pre = f"transformer.resblocks.{i}"
        out[f"{pre}.attn.in_proj_weight"] = np.concatenate(
            [_f32(attn[f"{n}_proj"]["kernel"]).T for n in "qkv"], axis=0)
        out[f"{pre}.attn.in_proj_bias"] = np.concatenate(
            [_f32(attn[f"{n}_proj"]["bias"]) for n in "qkv"], axis=0)
        out.update(_prefixed(f"{pre}.attn.out_proj", dense(attn["out_proj"])))
        out.update(_prefixed(f"{pre}.ln_1", layer_norm(blk["ln_1"])))
        out.update(_prefixed(f"{pre}.ln_2", layer_norm(blk["ln_2"])))
        out.update(_prefixed(f"{pre}.mlp.c_fc", dense(blk["c_fc"])))
        out.update(_prefixed(f"{pre}.mlp.c_proj", dense(blk["c_proj"])))
    return out


def clip_text(p: Mapping, layers: int) -> SD:
    return {
        "token_embedding.weight": _f32(p["token_embedding"]["embedding"]),
        "positional_embedding": _f32(p["positional_embedding"]),
        **_prefixed("ln_final", layer_norm(p["ln_final"])),
        "text_projection": _f32(p["text_projection"]),
        **clip_resblocks(p, layers),
    }


def clip_vit(p: Mapping) -> SD:
    """The JAX ``ClipVisionTransformer`` -> the port's (OpenAI's visual names)."""
    layers = sum(1 for k in p if k.startswith("resblock_"))
    return {
        "conv1.weight": conv_kernel(p["conv1"]),
        "class_embedding": _f32(p["class_embedding"]),
        "positional_embedding": _f32(p["positional_embedding"]),
        **_prefixed("ln_pre", layer_norm(p["ln_pre"])),
        **_prefixed("ln_post", layer_norm(p["ln_post"])),
        "proj": _f32(p["proj"]),
        **clip_resblocks(p, layers),
    }


def pretrained_encoder(name: str, p: Mapping, stats: Mapping) -> SD:
    """A ``models/pretrained_vision`` encoder's params and BatchNorm
    statistics -> its state_dict."""
    heads = {"vision_resnet_aff": ("fc1", "fc2", "fc3")}.get(name, ("fc1", "fc2"))
    out: SD = {}
    for h in heads:
        out.update(_prefixed(h, linear(p[h])))
    if name == "vision_clip":
        tower = p["clip"]
        out.update(_prefixed("clip", clip_resnet(tower, stats["clip"]) if "attnpool" in tower
                             else clip_vit(tower)))
    else:
        trunk = {"vision_r3m": "r3m", "tactile_encoder": "trunk"}.get(name, "resnet")
        out.update(_prefixed(trunk, resnet(p[trunk], stats[trunk])))
    return out


CONV_ENCODERS = ("vision_network", "vision_conv", "vision_network_gripper")


def perceptual_encoder(pe: Mapping, stats: Mapping, pe_cfg: dict) -> SD:
    """The encoders of the cameras the flax ``ConcatEncoders`` has params
    for (a camera it does not encode has none), by their config's name: a
    ``VisionNetwork``, ``VisionConv`` (with a ``trunk``) or
    ``VisionNetworkGripper``, or a pretrained architecture with its
    ``batch_stats``. The proprio slice has no parameters."""
    sd: SD = {}
    for cam in ("rgb_static", "depth_static", "rgb_gripper", "depth_gripper", "tactile"):
        if cam not in pe:
            continue
        enc, name = pe[cam], pe_cfg[cam]["_name_"]
        if name in CONV_ENCODERS:
            enc_sd = vision_network_gripper(enc) if "trunk" in enc else vision_network(enc)
        else:
            enc_sd = pretrained_encoder(name, enc, stats.get(cam, {}))
        sd.update(_prefixed(f"perceptual_encoder.{cam}_encoder", enc_sd))
    return sd


def flax_to_torch(params: Mapping[str, Any], model_cfg: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``Hulc2`` flax variables ({"params": ...}, and "batch_stats"
    when a pretrained encoder has BatchNorms) -> the port's ``state_dict``,
    for every model ``models/build.py`` builds: the camera and tactile
    encoders present (depth ones and no gripper one included) and trunks,
    the transformer, BiLSTM or BiRNN posterior, the decoder and its rnn, and
    whichever of the language network (CLIP text tower or ``lang_mlp``), the
    CLIP loss's projections and temperature, and the state, BC-Z, MIA and
    task heads the model has."""
    p = params["params"]
    stats = params.get("batch_stats", {}).get("perceptual_encoder", {})
    sd: SD = {
        **perceptual_encoder(p["perceptual_encoder"], stats, model_cfg["perceptual_encoder"]),
        **_prefixed("plan_proposal", plan_proposal(p["plan_proposal"])),
        **_prefixed("plan_recognition", plan_recognition(p["plan_recognition"],
                                                         model_cfg["plan_recognition"])),
        **_prefixed("visual_goal", goal_encoder(p["visual_goal"], has_dropout_front=False)),
        **_prefixed("language_goal", goal_encoder(p["language_goal"], has_dropout_front=True)),
        **_prefixed("action_decoder", action_decoder(p["action_decoder"])),
    }
    if "proj_vis_lang" in p:  # with the CLIP aux loss
        sd.update(_prefixed("proj_vis_lang", proj_vis_lang(p["proj_vis_lang"])))
        sd["logit_scale"] = _f32(p["logit_scale"]).reshape(())
    if "lang_net" in p:
        if model_cfg["language_encoder"]["_name_"] == "lang_mlp":
            sd.update({f"lang_net.mlp.{2 * i + 1}.{k}": v for i in range(3)
                       for k, v in linear(p["lang_net"][f"fc{i}"]).items()})
        else:
            sd.update(_prefixed("lang_net", clip_text(p["lang_net"],
                                                      model_cfg["language_encoder"]["layers"])))
    for head in ("lang_task_head", "state_decoder", "bcz_lang_decoder", "mia_discriminator"):
        if head in p:
            sd.update(_prefixed(head, two_layer(p[head])))
    return _tensors(sd)


def conv_kernel(p: Mapping) -> np.ndarray:
    """A bare flax nn.Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)."""
    return _f32(p["kernel"]).transpose(3, 2, 0, 1)


def batch_norm(p: Mapping, stats: Mapping) -> SD:
    return {"weight": _f32(p["scale"]), "bias": _f32(p["bias"]),
            "running_mean": _f32(stats["mean"]), "running_var": _f32(stats["var"])}


def resnet_blocks(p: Mapping, stats: Mapping) -> SD:
    """Every ``layer{s}_{b}`` block of a ResNet or CLIP ModifiedResNet:
    its ``conv{i}``/``bn{i}`` and ``ds_conv``/``ds_bn``."""
    out: SD = {}
    for name in (k for k in p if k.startswith("layer")):
        blk, blk_stats = p[name], stats[name]
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"),
                         ("ds_conv", "ds_bn")):
            if conv in blk:
                out[f"{name}.{conv}.weight"] = conv_kernel(blk[conv])
                out.update(_prefixed(f"{name}.{bn}", batch_norm(blk[bn], blk_stats[bn])))
    return out


def resnet(p: Mapping, stats: Mapping) -> SD:
    """``models/resnet.ResNet`` of any arch."""
    return {"conv1.weight": conv_kernel(p["conv1"]),
            **_prefixed("bn1", batch_norm(p["bn1"], stats["bn1"])), **resnet_blocks(p, stats)}


def clip_resnet(p: Mapping, stats: Mapping) -> SD:
    """``ClipModifiedResNet``: the three-conv stem, the blocks, the attention pool."""
    out: SD = {}
    for i in (1, 2, 3):
        out[f"conv{i}.weight"] = conv_kernel(p[f"conv{i}"])
        out.update(_prefixed(f"bn{i}", batch_norm(p[f"bn{i}"], stats[f"bn{i}"])))
    pool = p["attnpool"]
    out["attnpool.positional_embedding"] = _f32(pool["positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        out.update(_prefixed(f"attnpool.{proj}", dense(pool[proj])))
    return {**out, **resnet_blocks(p, stats)}


def _only(tree: Mapping, known, where: str) -> Mapping:
    """``tree``, after checking it holds no key outside ``known``."""
    extra = sorted(set(tree) - set(known))
    if extra:
        raise KeyError(f"{where}: unexpected flax keys {extra}")
    return tree


def fuser(p: Mapping) -> SD:
    """A fuser's params: bare ``nn.Conv`` children (``conv``, ``conv0``,
    ``conv1``: kernel [+ bias]) and the JAX package's ``Dense`` children
    (``gamma``/``beta``, ``q``/``k``/``v``, ``q{c}``/``k{c}``/``v{c}``)."""
    out: SD = {}
    for name, child in p.items():
        if "linear" in child:
            out.update(_prefixed(name, linear(child)))
        elif "kernel" in child:
            out[f"{name}.weight"] = conv_kernel(child)
            if "bias" in child:
                out[f"{name}.bias"] = _f32(child["bias"])
        else:
            raise KeyError(f"fuser: unexpected flax params {name!r}: {sorted(child)}")
    return out


def lang_fusion_decoder(p: Mapping, stats: Mapping, n_blocks: int) -> SD:
    out: SD = {}
    _only(p, [f"block{i}" for i in range(n_blocks)], "decoder")
    for i in range(n_blocks):
        blk = _only(p[f"block{i}"], ("lang_proj", "fuser", "conv1", "conv2"), f"block{i}")
        blk_stats = stats[f"block{i}"]
        if "lang_proj" in blk:
            out.update(_prefixed(f"blocks.{i}.lang_proj", linear(blk["lang_proj"])))
        if "fuser" in blk:
            out.update(_prefixed(f"blocks.{i}.fuser", fuser(blk["fuser"])))
        for c in ("conv1", "conv2"):
            out[f"blocks.{i}.{c}.conv.weight"] = conv_kernel(blk[c]["conv"])
            out.update(_prefixed(f"blocks.{i}.{c}.bn", batch_norm(blk[c]["bn"], blk_stats[c]["bn"])))
    return out


DEPTH_OUTPUTS = {"gaussian": ("depth_mu", "depth_sigma"),
                 "logistic": ("prob_fc", "mean_fc", "scale_fc")}


def detector_flax_to_torch(variables: Mapping[str, Any], aff_cfg: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``AffordanceDetector``'s flax variables ({"params", "batch_stats"})
    of any ``aff_detection`` group -> the port's ``state_dict``: the text
    tower (``text_tower``), the encoder (any ResNet, or CLIP's ModifiedResNet
    with its attention pool), the decoder's blocks with their fusers' params,
    the seg head and the depth head (``depth_dist``). A flax key the port has
    no place for raises; a missing one raises here or in ``load_state_dict``."""
    p, stats = variables["params"], variables["batch_stats"]
    tower, depth = aff_cfg.get("text_tower", False), aff_cfg.get("depth_dist") or None
    _only(p, ("aff_stream",) + (("lang_tower",) if tower else ()) + (("depth_stream",) if depth
                                                                      else ()), "detector")
    stream, stream_stats = _only(p["aff_stream"], ("encoder", "decoder", "seg_head"),
                                 "aff_stream"), stats["aff_stream"]
    encode = clip_resnet if aff_cfg["encoder_name"] == "clip_rn50" else resnet
    sd: SD = {
        **_prefixed("aff_stream.encoder", encode(stream["encoder"], stream_stats["encoder"])),
        **_prefixed("aff_stream.decoder", lang_fusion_decoder(
            stream["decoder"], stream_stats["decoder"], len(aff_cfg["decoder_channels"]))),
        "aff_stream.seg_head.weight": conv_kernel(stream["seg_head"]),
        "aff_stream.seg_head.bias": _f32(stream["seg_head"]["bias"]),
    }
    if tower:
        sd.update(_prefixed("lang_tower", clip_text(p["lang_tower"], aff_cfg["tower_layers"])))
    if depth:
        heads = ("fc1", "fc2", "fc3") + DEPTH_OUTPUTS[depth]
        for head in _only(p["depth_stream"], heads, "depth_stream"):
            sd.update(_prefixed(f"depth_stream.{head}", linear(p["depth_stream"][head])))
    return _tensors(sd)


# ---- upstream checkpoints -> the port's modules ---------------------------- #
def _upstream(sd: Mapping, prefix: str) -> SD:
    """The entries under ``prefix``, prefix stripped, as fp32 numpy arrays."""
    return {k[len(prefix):]: _f32(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
            for k, v in sd.items() if k.startswith(prefix)}


def _bn_upstream(sd: SD, src: str, dst: str) -> SD:
    return {f"{dst}.{n}": sd[f"{src}.{n}"] for n in ("weight", "bias", "running_mean", "running_var")}


def _blocks_upstream(sd: SD, layers, n_convs: int) -> SD:
    """torchvision/CLIP ``layer{s}.{b}.conv{i}``/``bn{i}`` and
    ``downsample.0``/``.1`` -> ``layer{s}_{b}.conv{i}``/``bn{i}``/``ds_conv``/``ds_bn``."""
    out: SD = {}
    for stage, n_blocks in enumerate(layers):
        for b in range(n_blocks):
            src, dst = f"layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            for i in range(1, n_convs + 1):
                out[f"{dst}.conv{i}.weight"] = sd[f"{src}.conv{i}.weight"]
                out.update(_bn_upstream(sd, f"{src}.bn{i}", f"{dst}.bn{i}"))
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.ds_conv.weight"] = sd[f"{src}.downsample.0.weight"]
                out.update(_bn_upstream(sd, f"{src}.downsample.1", f"{dst}.ds_bn"))
    return out


def convert_torchvision_resnet(sd: Mapping, arch: str = "resnet18",
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state_dict (under ``prefix``) -> ``models/resnet.ResNet(arch)``'s
    (``hulc2_tpu/models/resnet.py:145``); ``fc`` and ``num_batches_tracked`` are dropped."""
    from hulc2_torch.models.resnet import ARCHS

    block, layers = ARCHS[arch]
    up = _upstream(sd, prefix)
    out = {"conv1.weight": up["conv1.weight"], **_bn_upstream(up, "bn1", "bn1")}
    out.update(_blocks_upstream(up, layers, 3 if block.expansion == 4 else 2))
    return _tensors(out)


def convert_r3m_checkpoint(state_dict: Mapping, arch: str = "resnet18") -> Dict[str, torch.Tensor]:
    """An R3M checkpoint (``module.convnet.*``, ``convnet.*`` or
    ``r3m.convnet.*``) -> the trunk of ``VisionR3M`` (its ``r3m`` module;
    ``pretrained_vision.py:149``)."""
    for prefix in ("module.convnet.", "convnet.", "r3m.convnet."):
        if any(k.startswith(prefix) for k in state_dict):
            return convert_torchvision_resnet(state_dict, arch, prefix)
    raise KeyError("no convnet.* keys found in R3M checkpoint")


def convert_clip_visual(sd: Mapping, layers=(3, 4, 6, 3),
                        prefix: str = "visual.") -> Dict[str, torch.Tensor]:
    """OpenAI CLIP's ModifiedResNet (``visual.*``) -> ``ClipModifiedResNet``'s
    state_dict (``clip_resnet.py:126``); the attention pool keeps its names."""
    up = _upstream(sd, prefix)
    out: SD = {}
    for i in (1, 2, 3):
        out[f"conv{i}.weight"] = up[f"conv{i}.weight"]
        out.update(_bn_upstream(up, f"bn{i}", f"bn{i}"))
    out.update(_blocks_upstream(up, layers, 3))
    out.update({k: v for k, v in up.items() if k.startswith("attnpool.")})
    return _tensors(out)


def convert_clip_vit(sd: Mapping, prefix: str = "visual."):
    """OpenAI CLIP's ViT (``visual.*``) -> (``ClipVisionTransformer``'s
    state_dict, its constructor kwargs) (``clip_vit.py:70``): the names are
    kept, the sizes read off the weights."""
    up = _upstream(sd, prefix)
    width = up["ln_pre.weight"].shape[0]
    layers = 1 + max(int(k.split(".")[2]) for k in up if k.startswith("transformer.resblocks."))
    patch = up["conv1.weight"].shape[-1]
    n_pos = up["positional_embedding"].shape[0]
    kwargs = dict(patch_size=patch, width=width, layers=layers, heads=max(1, width // 64),
                  output_dim=up["proj"].shape[1],
                  input_resolution=patch * int(round((n_pos - 1) ** 0.5)))
    return _tensors(up), kwargs


def load_lightning_checkpoint(path):
    """(state_dict, hyper_parameters) of a ``.ckpt`` written by the reference
    trainer (``torch.save`` of {"state_dict": ..., "hyper_parameters": ...})
    (``hulc2_tpu/utils/convert.py:316``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("state_dict", ckpt), ckpt.get("hyper_parameters", {})
