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

``detector_flax_to_torch(variables, aff_cfg)`` does the same for the JAX
``AffordanceDetector``'s {"params", "batch_stats"}: ``TorchBatchNorm`` and
flax ``nn.BatchNorm`` scale/bias/mean/var -> weight/bias/running_mean/
running_var, the tower through the CLIP mapping.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

SD = Dict[str, np.ndarray]


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


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


def clip_text(p: Mapping, layers: int) -> SD:
    out = {
        "token_embedding.weight": _f32(p["token_embedding"]["embedding"]),
        "positional_embedding": _f32(p["positional_embedding"]),
        **_prefixed("ln_final", layer_norm(p["ln_final"])),
        "text_projection": _f32(p["text_projection"]),
    }
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


def perceptual_encoder(pe: Mapping) -> SD:
    """The encoders of the cameras the flax ``ConcatEncoders`` has params
    for (a camera it does not encode has none): the static and depth_static
    ones a ``VisionNetwork`` or, with a ``trunk``, a ``VisionConv``; the
    gripper and depth_gripper ones a ``VisionNetworkGripper``. The proprio
    slice has no parameters."""
    sd: SD = {}
    for cam in ("rgb_static", "depth_static", "rgb_gripper", "depth_gripper"):
        if cam in pe:
            enc = pe[cam]
            sd.update(_prefixed(f"perceptual_encoder.{cam}_encoder",
                                vision_network_gripper(enc) if "trunk" in enc
                                else vision_network(enc)))
    return sd


def flax_to_torch(params: Mapping[str, Any], model_cfg: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``Hulc2`` flax variables ({"params": ...}) -> the port's
    ``state_dict``, for every model ``models/build.py`` builds: the camera
    encoders present (depth ones and no gripper one included) and trunks, the transformer, BiLSTM or BiRNN posterior, the decoder and
    its rnn, and whichever of the language network (CLIP text tower or
    ``lang_mlp``), the CLIP loss's projections and temperature, and the
    state, BC-Z, MIA and task heads the model has."""
    p = params["params"]
    sd: SD = {
        **perceptual_encoder(p["perceptual_encoder"]),
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
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def conv_kernel(p: Mapping) -> np.ndarray:
    """A bare flax nn.Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)."""
    return _f32(p["kernel"]).transpose(3, 2, 0, 1)


def batch_norm(p: Mapping, stats: Mapping) -> SD:
    return {"weight": _f32(p["scale"]), "bias": _f32(p["bias"]),
            "running_mean": _f32(stats["mean"]), "running_var": _f32(stats["var"])}


def resnet18(p: Mapping, stats: Mapping) -> SD:
    out = {"conv1.weight": conv_kernel(p["conv1"]), **_prefixed("bn1", batch_norm(p["bn1"], stats["bn1"]))}
    for stage in range(1, 5):
        for b in range(2):
            name = f"layer{stage}_{b}"
            blk, blk_stats = p[name], stats[name]
            for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("ds_conv", "ds_bn")):
                if conv in blk:
                    out[f"{name}.{conv}.weight"] = conv_kernel(blk[conv])
                    out.update(_prefixed(f"{name}.{bn}", batch_norm(blk[bn], blk_stats[bn])))
    return out


def lang_fusion_decoder(p: Mapping, stats: Mapping, n_blocks: int) -> SD:
    out: SD = {}
    for i in range(n_blocks):
        blk, blk_stats = p[f"block{i}"], stats[f"block{i}"]
        if "lang_proj" in blk:
            out.update(_prefixed(f"blocks.{i}.lang_proj", linear(blk["lang_proj"])))
        for c in ("conv1", "conv2"):
            out[f"blocks.{i}.{c}.conv.weight"] = conv_kernel(blk[c]["conv"])
            out.update(_prefixed(f"blocks.{i}.{c}.bn", batch_norm(blk[c]["bn"], blk_stats[c]["bn"])))
    return out


def detector_flax_to_torch(variables: Mapping[str, Any], aff_cfg: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``AffordanceDetector``'s flax variables ({"params", "batch_stats"})
    of the ``rn18_tokens_pixel`` family -> the port's ``state_dict``."""
    p, stats = variables["params"], variables["batch_stats"]
    stream, stream_stats = p["aff_stream"], stats["aff_stream"]
    sd: SD = {
        **_prefixed("lang_tower", clip_text(p["lang_tower"], aff_cfg["tower_layers"])),
        **_prefixed("aff_stream.encoder", resnet18(stream["encoder"], stream_stats["encoder"])),
        **_prefixed("aff_stream.decoder", lang_fusion_decoder(
            stream["decoder"], stream_stats["decoder"], len(aff_cfg["decoder_channels"]))),
        "aff_stream.seg_head.weight": conv_kernel(stream["seg_head"]),
        "aff_stream.seg_head.bias": _f32(stream["seg_head"]["bias"]),
    }
    for head in ("fc1", "fc2", "fc3", "depth_mu", "depth_sigma"):
        sd.update(_prefixed(f"depth_stream.{head}", linear(p["depth_stream"][head])))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
