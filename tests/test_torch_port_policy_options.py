"""The policy's model options in the port against the JAX package, on the CPU in fp32.

Every module the options add (the GRU, LSTM and BiLSTM with and without an
initial state, the BiRNN and BiLSTM posteriors, the continuous plans' KL
and sample, the deterministic decoder and its loss, ``lang_mlp``, the
gripper trunks, ``VisionConv``, sinusoid features and a learned
temperature, every activation, the transformer posterior's LayerNorms and
padding, the aux heads): JAX's module gets a flax tree of its ``init``'s
shapes and seeded values (``random_flax_params``), ``flax_to_torch``'s
pieces carry it into the port, both run on the same inputs, rtol 1e-4.

Then three train steps of ``cfg_gcbc`` and of one config per option, the
aux heads with their betas among them, on the same batches, offsets and
plan noise, both sides from the same weights: losses rtol 1e-3; and
``policy_step`` rollouts over two replan periods with a per-env reset in
the middle for the ReLU-RNN, GRU, LSTM and GCBC carries: actions atol 1e-5.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hulc2_tpu.configs  # noqa: F401  (registers the JAX groups)
from _torch_port_common import _jax_shift_normalize, random_flax_params, shift_draws
from hulc2_torch.agents.hulc2_agent import Hulc2Agent
from hulc2_torch.core import config as cfg_lib
from hulc2_torch.data.device_transforms import camera_sizes, make_batch_transform
from hulc2_torch.models import aux_nets, decoders, goal_encoders, layers, plan_nets, vision
from hulc2_torch.models.build import build_policy
from hulc2_torch.models.distributions import ContinuousPlanDistribution
from hulc2_torch.models.hulc2 import PolicyDraws
from hulc2_torch.train.optim import make_optimizer, make_scheduler
from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step
from hulc2_torch.utils import convert

RTOL, ATOL = 1e-4, 2e-5
SIZES = camera_sizes("rand_shift")
PADS = {"rgb_static": 10, "rgb_gripper": 4}
EMB_DIM = 384
R1, R2 = 1e-5, 1.0 - 1e-5


def _flax_params(module, *args, seed=0, method=None):
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, method=method), *args)
    return random_flax_params(shapes, seed)


def _load(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---- the recurrent layers ------------------------------------------------- #
RNN_CASES = {
    "gru": ("GRU", {}, False),
    "gru_h0": ("GRU", {}, True),
    "lstm": ("LSTM", {}, False),
    "lstm_h0": ("LSTM", {}, True),
    "bilstm": ("LSTM", {"bidirectional": True}, False),
    "bilstm_h0": ("LSTM", {"bidirectional": True}, True),
}


@pytest.mark.parametrize("case", list(RNN_CASES))
def test_recurrent_layer_matches_jax(case):
    """Outputs and final states of the stacked cell from the same weights
    and initial state; the library layer and the port's plain loop alike."""
    from hulc2_tpu.models import layers as jlayers

    kind, kw, with_h0 = RNN_CASES[case]
    rng = np.random.default_rng(len(case))
    b, s, f, h, n = 3, 5, 10, 16, 2
    d = 2 if kw.get("bidirectional") else 1
    x = _randn(rng, b, s, f)
    state = None
    if with_h0:
        state = (_randn(rng, n * d, b, h), _randn(rng, n * d, b, h)) if kind == "LSTM" \
            else _randn(rng, n, b, h)
    jmod = getattr(jlayers, kind)(h, n, **kw)
    jstate = None if state is None else jax.tree_util.tree_map(jnp.asarray, state)
    params = _flax_params(jmod, jnp.asarray(x), jstate, seed=3)
    want_y, want_h = jmod.apply(params, jnp.asarray(x), jstate)
    tmod = _load(getattr(layers, kind)(f, h, n, **kw), convert.rnn_weights(params["params"]))
    tstate = None if state is None else (tuple(map(torch.from_numpy, state)) if kind == "LSTM"
                                         else torch.from_numpy(state))
    plain = layers.lstm_plain if kind == "LSTM" else layers.gru_plain
    with torch.no_grad():
        for tag, (got_y, got_h) in (("library", tmod(torch.from_numpy(x), tstate)),
                                    ("plain", plain(tmod, torch.from_numpy(x), tstate))):
            _close(got_y, want_y, f"{tag} outputs")
            for g, w in zip(jax.tree_util.tree_leaves(got_h), jax.tree_util.tree_leaves(want_h)):
                _close(g, w, f"{tag} state")


@pytest.mark.parametrize("kind", ["bilstm", "birnn"])
def test_recurrent_posterior_matches_jax(kind):
    """The BiLSTM and BiRNN posteriors' plan state and seq_feat (the last
    step of both directions' outputs), discrete plans."""
    from hulc2_tpu.models import plan_nets as jplan
    from hulc2_tpu.models.distributions import PlanDistribution

    rng = np.random.default_rng(7)
    x = _randn(rng, 3, 6, 20)
    dist = PlanDistribution("discrete", 4, 5)
    cls = {"bilstm": "PlanRecognitionBiLSTM", "birnn": "PlanRecognitionBiRNN"}[kind]
    jmod = getattr(jplan, cls)(dist=dist, hidden_size=12, num_layers=2)
    params = _flax_params(jmod, jnp.asarray(x), seed=8)
    want_state, want_feat = jmod.apply(params, jnp.asarray(x))
    sd = convert.plan_recognition(params["params"], {"kind": kind})
    tmod = _load(getattr(plan_nets, cls)(20, 20, hidden_size=12, num_layers=2), sd)
    assert tmod.seq_features == 24
    with torch.no_grad():
        got_state, got_feat = tmod(torch.from_numpy(x))
    _close(got_state, want_state.logit, "state")
    _close(got_feat, want_feat, "seq_feat")


@pytest.mark.parametrize("norms", ["none", "positional", "encoder", "both"])
def test_transformer_posterior_norms_and_padding_match_jax(norms):
    """LayerNorms after the positions and after the encoder, and a feature
    width (21) that the heads (4) do not divide, zero-padded to 24."""
    from hulc2_tpu.models.distributions import PlanDistribution
    from hulc2_tpu.models.plan_nets import PlanRecognitionTransformer as JPR

    kw = dict(positional_normalize=norms in ("positional", "both"),
              encoder_normalize=norms in ("encoder", "both"))
    rng = np.random.default_rng(9)
    x = _randn(rng, 2, 5, 21)
    jmod = JPR(dist=PlanDistribution("discrete", 4, 5), num_heads=4, num_layers=2,
               encoder_hidden_size=16, fc_hidden_size=24, max_position_embeddings=8,
               dropout_p=0.0, **kw)
    params = _flax_params(jmod, jnp.asarray(x), seed=10)
    want_state, want_feat = jmod.apply(params, jnp.asarray(x))
    tmod = _load(plan_nets.PlanRecognitionTransformer(21, 20, 4, 2, 16, 24, 8, 0.0, **kw),
                 convert.plan_recognition(params["params"], {"num_layers": 2}))
    assert tmod.pad == 3
    with torch.no_grad():
        got_state, got_feat = tmod(torch.from_numpy(x))
    _close(got_state, want_state.logit, "state")
    _close(got_feat, want_feat, "seq_feat")


# ---- continuous plans ----------------------------------------------------- #
def test_continuous_plans_match_jax():
    """The softplus scale, the closed-form KL both ways and the balanced
    mix, and rsample from JAX's own normal draws."""
    from hulc2_tpu.models.distributions import PlanDistribution

    rng = np.random.default_rng(11)
    p, q = _randn(rng, 4, 2 * 6) * 2, _randn(rng, 4, 2 * 6) * 2
    jd, td = PlanDistribution("continuous", plan_features=6), ContinuousPlanDistribution(6)
    assert td.state_dim == jd.state_dim == 12
    jp, jq = jd.forward_dist(jnp.asarray(p)), jd.forward_dist(jnp.asarray(q))
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    _close(td.mean_std(tp)[1], jp.std, "std")
    _close(td.kl_divergence(tp, tq), jd.kl_divergence(jp, jq), "kl(p, q)")
    _close(td.kl_divergence(tq, tp), jd.kl_divergence(jq, jp), "kl(q, p)")
    _close((0.8 * td.kl_divergence(tp, tq) + 0.2 * td.kl_divergence(tp, tq)).mean(),
           jd.kl_balanced(jq, jp, 0.8), "balanced")
    key = jax.random.PRNGKey(12)
    want = jd.rsample(key, jp)
    eps = np.array(jax.random.normal(key, jp.mean.shape, jp.mean.dtype))
    _close(td.rsample(tp, torch.from_numpy(eps)), want, "rsample")
    tp.requires_grad_(True)
    td.rsample(tp, torch.from_numpy(eps)).sum().backward()
    assert tp.grad.abs().sum() > 0  # reparameterized: gradients reach mean and scale
    draw = td.sample(tp.detach(), generator=torch.Generator().manual_seed(0))
    assert draw.shape == (4, 6) and torch.isfinite(draw).all()


# ---- decoders -------------------------------------------------------------- #
DECODER_CASES = [("rnn_decoder", True), ("gru_decoder", True), ("lstm_decoder", True),
                 ("mlp_decoder", True), ("rnn_decoder", False), ("lstm_decoder", False)]


@pytest.mark.parametrize("rnn_model,discrete", DECODER_CASES,
                         ids=[f"{m}-{'discrete' if d else 'mixture'}" for m, d in DECODER_CASES])
def test_logistic_decoder_options_match_jax(rnn_model, discrete):
    """Each rnn_model from a given state (the LSTM's (h, c)), and without a
    discrete gripper the mixture over all 7 dims and no gripper head."""
    from hulc2_tpu.models.decoders import LogisticPolicyDecoder as JDec

    rng = np.random.default_rng(13)
    b, s, h = 2, 4, 16
    plan, emb, goal = _randn(rng, b, 20), _randn(rng, b, s, 128), _randn(rng, b, 8)
    h0 = None
    if rnn_model in ("rnn_decoder", "gru_decoder"):
        h0 = _randn(rng, 2, b, h)
    elif rnn_model == "lstm_decoder":
        h0 = (_randn(rng, 2, b, h), _randn(rng, 2, b, h))
    jh0 = None if h0 is None else jax.tree_util.tree_map(jnp.asarray, h0)
    jmod = JDec(hidden_size=h, rnn_model=rnn_model, discrete_gripper=discrete)
    args = tuple(map(jnp.asarray, (plan, emb, goal)))
    params = _flax_params(jmod, *args, jh0, seed=14)
    want = jmod.apply(params, *args, jh0)
    tmod = _load(decoders.LogisticPolicyDecoder(20 + 64 + 8, hidden_size=h, rnn_model=rnn_model,
                                                discrete_gripper=discrete),
                 convert.action_decoder(params["params"]))
    th0 = None if h0 is None else (tuple(map(torch.from_numpy, h0)) if isinstance(h0, tuple)
                                   else torch.from_numpy(h0))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, (plan, emb, goal)), th0)
    assert got.logit_probs.shape == (b, s, 6 if discrete else 7, 10)
    assert (got.gripper_logits is None) == (not discrete)
    for name in ("logit_probs", "log_scales", "means") + (("gripper_logits",) if discrete else ()):
        _close(getattr(got, name), getattr(want, name), name)
    for g, w in zip(jax.tree_util.tree_leaves(got.hidden), jax.tree_util.tree_leaves(want.hidden)):
        _close(g, w, "hidden")


@pytest.mark.parametrize("criterion", ["HuberLoss", "MSELoss"])
def test_deterministic_decoder_and_loss_match_jax(criterion):
    """tanh actions over the rnn from an empty (GCBC) plan, and the Huber
    (errors on both sides of delta 1) or MSE loss on TCP-frame targets."""
    from hulc2_tpu.models.decoders import DeterministicDecoder as JDet

    rng = np.random.default_rng(15)
    b, s = 3, 4
    plan, emb, goal = np.zeros((b, 0), np.float32), _randn(rng, b, s, 128), _randn(rng, b, 8)
    actions = _randn(rng, b, s, 7) * 1.5
    robot = rng.uniform(-1, 1, (b, s, 15)).astype(np.float32)
    jmod = JDet(hidden_size=16, criterion=criterion, gripper_control=True)
    args = tuple(map(jnp.asarray, (plan, emb, goal)))
    params = _flax_params(jmod, *args, seed=16)
    want_act, want_h = jmod.apply(params, *args)
    want_loss = jmod.compute_loss(want_act, jnp.asarray(actions), jnp.asarray(robot))
    tmod = _load(decoders.DeterministicDecoder(64 + 8, hidden_size=16, criterion=criterion,
                                               gripper_control=True),
                 convert.action_decoder(params["params"]))
    with torch.no_grad():
        got_act, got_h = tmod(*map(torch.from_numpy, (plan, emb, goal)))
        got_loss = tmod.compute_loss(got_act, torch.from_numpy(actions), torch.from_numpy(robot))
    _close(got_act, want_act, "actions")
    _close(got_h, want_h, "hidden")
    _close(got_loss, want_loss, "loss")


# ---- language, goals, vision ----------------------------------------------- #
ACTIVATIONS = ["ReLU", "ELU", "GELU", "Tanh", "SiLU"]


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_lang_mlp_and_activation_match_jax(activation):
    """``lang_mlp`` with each activation (GELU is JAX's tanh approximation),
    and the activation alone on values over [-6, 6]."""
    from hulc2_tpu.models.goal_encoders import LanguageEncoderMLP as JMLP
    from hulc2_tpu.models.layers import get_activation as jact

    z = np.linspace(-6, 6, 241, dtype=np.float32)
    _close(layers.get_activation(activation)(torch.from_numpy(z)), jact(activation)(z), activation,
           rtol=1e-5, atol=1e-6)
    rng = np.random.default_rng(17)
    x = _randn(rng, 3, 24)
    jmod = JMLP(out_features=12, hidden_size=20, activation_function=activation)
    params = _flax_params(jmod, jnp.asarray(x), seed=18)
    want = jmod.apply(params, jnp.asarray(x))
    sd = {f"mlp.{2 * i + 1}.{k}": v for i in range(3)
          for k, v in convert.linear(params["params"][f"fc{i}"]).items()}
    tmod = _load(goal_encoders.LanguageEncoderMLP(24, 12, 20, activation_function=activation), sd)
    with torch.no_grad():
        _close(tmod(torch.from_numpy(x)), want)


def test_word_dropout_and_l2_goals():
    """Word dropout is an inverted dropout of the sentence embedding: each
    entry zero or scaled by 1/(1-p), drawn from the generator, none when
    deterministic. The goal encoders' L2 option against JAX."""
    from hulc2_tpu.models.goal_encoders import LanguageGoalEncoder as JLang
    from hulc2_tpu.models.goal_encoders import VisualGoalEncoder as JVis

    enc = goal_encoders.LanguageGoalEncoder(16, 20, 8, word_dropout_p=0.25)
    enc.mlp[0] = torch.nn.Identity()
    x = torch.ones(64, 16)
    seen = {}
    enc.mlp.register_forward_hook(lambda m, i, o: seen.update(x=i[0]))
    enc(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(np.unique(seen["x"].numpy()), [0.0, 1 / 0.75], rtol=1e-6)
    assert 0.15 < (seen["x"] == 0).float().mean() < 0.35
    enc(x, deterministic=True)
    assert torch.equal(seen["x"], x)
    rng = np.random.default_rng(19)
    for jcls, tcls, front in ((JVis, goal_encoders.VisualGoalEncoder, False),
                              (JLang, goal_encoders.LanguageGoalEncoder, True)):
        y = _randn(rng, 3, 16)
        jmod = jcls(latent_goal_features=8, hidden_size=20, l2_normalize_goal_embeddings=True)
        params = _flax_params(jmod, jnp.asarray(y), seed=20)
        tmod = _load(tcls(16, 20, 8, l2_normalize_goal_embeddings=True),
                     convert.goal_encoder(params["params"], has_dropout_front=front))
        with torch.no_grad():
            _close(tmod(torch.from_numpy(y)), jmod.apply(params, jnp.asarray(y)), jcls.__name__)


VISION_CASES = {
    "static_sinusoid": ("VisionNetwork", 96, {"use_sinusoid": True}),
    "static_learned_temp": ("VisionNetwork", 96, {"spatial_softmax_temp": None}),
    "static_temp_0.5_elu_l2": ("VisionNetwork", 96, {"spatial_softmax_temp": 0.5,
                                                     "activation_function": "ELU",
                                                     "l2_normalize_output": True}),
    "gripper_cnn_3_layers": ("VisionNetworkGripper", 84, {"conv_encoder": "cnn_3_layers"}),
    "gripper_cnn_4_layers_silu": ("VisionNetworkGripper", 84,
                                  {"conv_encoder": "cnn_4_layers", "activation_function": "SiLU"}),
    "gripper_nature_gelu_l2": ("VisionNetworkGripper", 84, {"activation_function": "GELU",
                                                            "l2_normalize_output": True}),
    "vision_conv_200": ("VisionConv", 200, {}),
    "vision_conv_tanh_66": ("VisionConv", 66, {"activation_function": "Tanh"}),
}


@pytest.mark.parametrize("case", list(VISION_CASES))
def test_vision_options_match_jax(case):
    """The encoders' options; 66 px is a size the stem cannot pack
    (not 4-divisible), so JAX keeps the plain 8x8 kernel there."""
    from hulc2_tpu.models import vision as jvision

    cls, hw, kw = VISION_CASES[case]
    x = np.random.default_rng(21).standard_normal((2, hw, hw, 3)).astype(np.float32)
    jmod = getattr(jvision, cls)(visual_features=16, **kw)
    params = _flax_params(jmod, jnp.asarray(x), seed=22)
    want = jmod.apply(params, jnp.asarray(x))
    p = params["params"]
    if cls == "VisionNetwork":
        tmod, sd = vision.VisionNetwork(16, **kw), convert.vision_network(p)
        assert ("temperature" in sd) == (kw.get("spatial_softmax_temp", 1.0) is None)
    else:
        tmod, sd = getattr(vision, cls)(hw, 16, **kw), convert.vision_network_gripper(p)
    tmod = _load(tmod, sd)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tmod(xt)
    _close(got, want, rtol=1e-4, atol=5e-5)
    if kw.get("spatial_softmax_temp", 1.0) is None:
        got.sum().backward()  # the temperature learns
        assert tmod.temperature.grad is not None and tmod.temperature.grad.abs().item() > 0


AUX_CASES = {
    "state_decoder": ("StateDecoder", 1),
    "bcz_lang_decoder": ("BCZLangDecoder", 1),
    "mia_discriminator": ("MIALangDiscriminator", 2),
}


@pytest.mark.parametrize("name", list(AUX_CASES))
def test_aux_heads_match_jax(name):
    from hulc2_tpu.models import aux_nets as jaux

    cls, n_in = AUX_CASES[name]
    rng = np.random.default_rng(23)
    xs = [_randn(rng, 4, 24), _randn(rng, 4, 12)][:n_in]
    kw = {"StateDecoder": {"n_state_obs": 8}, "BCZLangDecoder": {"lang_dim": 12},
          "MIALangDiscriminator": {}}[cls]
    jmod = getattr(jaux, cls)(**kw)
    params = _flax_params(jmod, *map(jnp.asarray, xs), seed=24)
    want = jmod.apply(params, *map(jnp.asarray, xs))
    targs = {"StateDecoder": (24, 8), "BCZLangDecoder": (24, 12),
             "MIALangDiscriminator": (24, 12)}[cls]
    tmod = _load(getattr(aux_nets, cls)(*targs), convert.two_layer(params["params"]))
    with torch.no_grad():
        _close(tmod(*map(torch.from_numpy, xs)), want)


# ---- the whole policy: train steps ---------------------------------------- #
# cfg_low_level's and cfg_gcbc's structure at narrow widths, fp32, no dropout
SMALL = [
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=24", "model.plan_recognition.dropout_p=0.0",
    "model.distribution.category_size=4", "model.distribution.class_size=5",
    "model.visual_goal.hidden_size=32", "model.visual_goal.latent_goal_features=8",
    "model.language_goal.hidden_size=32", "model.language_goal.latent_goal_features=8",
    "model.action_decoder.hidden_size=24", "model.proj_vis_lang.output_dim=16",
    "model.compute_dtype=\"float32\"", "datamodule.batch_size_vis=2",
    "datamodule.batch_size_lang=3", "datamodule.min_window_size=3",
    "datamodule.max_window_size=3",
]
RECURRENT = ["model.action_decoder.rnn_model=lstm_decoder", "model/plan_recognition=bilstm",
             "model/distribution=continuous", "model/optimizer=adamw",
             "model/lr_scheduler=cosine_warmup"]
AUX = ["model.use_state_recons=true", "model.use_bc_z_auxiliary_loss=true",
       "model.use_mia_auxiliary_loss=true"]
TRAIN_CASES = {
    "cfg_gcbc": ("cfg_gcbc", []),
    "gcbc_aux_heads": ("cfg_gcbc", AUX),
    "aux_heads_no_clip": ("cfg_low_level", AUX + ["model.use_clip_auxiliary_loss=false"]),
    "recurrent_variant": ("cfg_low_level", RECURRENT),
    "gru_decoder": ("cfg_low_level", ["model.action_decoder.rnn_model=gru_decoder"]),
    "mlp_decoder": ("cfg_low_level", ["model.action_decoder.rnn_model=mlp_decoder"]),
    "mixture_gripper": ("cfg_low_level", ["model.action_decoder.discrete_gripper=false"]),
    "birnn_posterior": ("cfg_low_level", ["model/plan_recognition=birnn"]),
    "continuous_plans": ("cfg_low_level", ["model/distribution=continuous",
                                           "model.distribution.plan_features=12"]),
    "transformer_norms": ("cfg_low_level", ["model.plan_recognition.encoder_normalize=true",
                                            "model.plan_recognition.positional_normalize=true"]),
    "lang_mlp_word_dropout_0": ("cfg_low_level", ["model/language_encoder=mlp",
                                                  "model.language_encoder.hidden_size=32",
                                                  "model.language_encoder.out_features=16"]),
    "vision_conv_cnn_4_layers": ("cfg_low_level", [
        "model/perceptual_encoder/rgb_static=vision_conv",
        "model.perceptual_encoder.rgb_gripper.conv_encoder=\"cnn_4_layers\""]),
    "vision_sinusoid_temp_cnn_3": ("cfg_low_level", [
        "model.perceptual_encoder.rgb_static.use_sinusoid=true",
        "model.perceptual_encoder.rgb_static.spatial_softmax_temp=null",
        "model.perceptual_encoder.rgb_gripper.conv_encoder=\"cnn_3_layers\"",
        "model.perceptual_encoder.rgb_gripper.activation_function=\"ELU\"",
        "model.perceptual_encoder.rgb_static.l2_normalize_output=true"]),
    "sgd_linear_warmup_clip": ("cfg_low_level", ["model/optimizer=sgd",
                                                 "model/lr_scheduler=linear_warmup",
                                                 "model.optimizer.gradient_clip_norm=1.0"]),
    "adamw_clip": ("cfg_low_level", ["model/optimizer=adamw", "model.optimizer.weight_decay=0.01",
                                     "model.optimizer.gradient_clip_norm=2.0"]),
}
# the JAX factory builds the recurrent posteriors at 2048 x 2; both sides
# build them at 16 here (the port's build reads the width off the module)
NARROW_POSTERIOR = 16
ESTIMATED_TOTAL = 20  # the schedules' length: a warm-up of 2 updates


def _narrow_posteriors(monkeypatch):
    import hulc2_tpu.models.build as jbuild
    import hulc2_torch.models.build as tbuild

    for mod in (jbuild, tbuild):
        for cls in ("PlanRecognitionBiLSTM", "PlanRecognitionBiRNN"):
            monkeypatch.setattr(mod, cls, functools.partial(getattr(mod, cls),
                                                            hidden_size=NARROW_POSTERIOR))


def _install_noise(monkeypatch) -> dict:
    """JAX's plan sampler and rsample with the noise in the holder's "n":
    Gumbel for discrete plans, standard normal for continuous ones."""
    from hulc2_tpu.models.distributions import PlanDistribution

    holder = {}

    def one_hot(self, state):
        logits = self._logits(state)
        idx = jnp.argmax(logits + holder.get("n", 0.0), axis=-1)
        return logits, jax.nn.one_hot(idx, self.class_size, dtype=logits.dtype)

    def rsample(self, rng, state):
        if self.dist == "continuous":
            return state.mean + state.std * holder.get("n", 0.0)
        logits, oh = one_hot(self, state)
        probs = jax.nn.softmax(logits, axis=-1)
        st = oh + probs - jax.lax.stop_gradient(probs)
        return st.reshape(*st.shape[:-2], -1)

    def sample(self, rng, state):
        if self.dist == "continuous":
            return state.mean + state.std * holder.get("n", 0.0)
        _, oh = one_hot(self, state)
        return oh.reshape(*oh.shape[:-2], -1)

    monkeypatch.setattr(PlanDistribution, "rsample", rsample)
    monkeypatch.setattr(PlanDistribution, "sample", sample)
    return holder


def _noise(rng, cfg: dict, b: int) -> np.ndarray:
    d = cfg["model"]["distribution"]
    if d["dist"] == "continuous":
        return rng.standard_normal((b, d["plan_features"])).astype(np.float32)
    return rng.gumbel(size=(b, d["category_size"], d["class_size"])).astype(np.float32)


def _fused_batch(rng, cfg: dict) -> dict:
    dm = cfg["datamodule"]
    bv, bl, s = dm["batch_size_vis"], dm["batch_size_lang"], dm["max_window_size"]
    b = bv + bl
    acts = np.clip(rng.standard_normal((b, s, 7)) * 0.3, -1, 1).astype(np.float32)
    acts[..., -1] = np.sign(acts[..., -1] + 1e-6)
    out = {cam: rng.integers(0, 256, (b, s, hw, hw, 3), dtype=np.uint8) for cam, hw in SIZES.items()}
    out.update(robot_obs_raw=rng.standard_normal((b, s, 15)).astype(np.float32), actions=acts,
               lang=rng.standard_normal((bl, EMB_DIM)).astype(np.float32),
               use_for_aux_lang_loss=np.array([True, False] + [True] * (bl - 2)),
               lang_task_id=np.zeros(bl, np.int32))
    return out


def _jax_batch(fused: dict, offsets: dict, robot_obs) -> dict:
    return {
        "rgb_obs": {cam: _jax_shift_normalize(jnp.asarray(fused[cam]), jnp.asarray(offsets[cam]), pad)
                    for cam, pad in PADS.items()},
        "depth_obs": {}, "robot_obs": jnp.asarray(robot_obs),
        "robot_obs_raw": jnp.asarray(fused["robot_obs_raw"]),
        "actions": jnp.asarray(fused["actions"]), "lang": jnp.asarray(fused["lang"]),
        "use_for_aux_lang_loss": jnp.asarray(fused["use_for_aux_lang_loss"]),
    }


def _offsets(rng, n: int) -> dict:
    return {cam: rng.integers(0, 2 * pad + 1, (n, 2)).astype(np.int32) for cam, pad in PADS.items()}


def _transform(cfg: dict, train: bool = True):
    dm = cfg["datamodule"]
    return make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                dm["transforms"], train=train)


def build_pair(cfg: dict, seed: int = 0):
    """(JAX model, flax params, port model with the same weights)."""
    from hulc2_tpu.models.build import build_policy as jax_build_policy

    jmodel = jax_build_policy(cfg["model"])
    rng = np.random.default_rng(seed)
    fused = _fused_batch(rng, cfg)
    b, s = fused["actions"].shape[:2]
    n_vis = cfg["datamodule"]["batch_size_vis"]
    keys = {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    batch = _jax_batch(fused, _offsets(rng, b * s), fused["robot_obs_raw"][..., :8])
    shapes = jax.eval_shape(lambda k, bt: jmodel.init(k, bt, 0.01, False, n_vis), keys, batch)
    params = random_flax_params(shapes, seed)
    tmodel = build_policy(cfg["model"], gripper_hw=SIZES["rgb_gripper"],
                          static_hw=SIZES["rgb_static"])
    tmodel.load_state_dict(convert.flax_to_torch(params, cfg["model"]), strict=True)
    return jmodel, params, tmodel


def _jax_train_step(jmodel, cfg: dict, holder: dict):
    from hulc2_tpu.train import optim as joptim

    mc, loss_cfg = cfg["model"], cfg["loss"]
    n_vis = cfg["datamodule"]["batch_size_vis"]
    tx = joptim.make_optimizer(mc["optimizer"], mc.get("lr_scheduler"), ESTIMATED_TOTAL)
    betas = {"lang_clip_loss": loss_cfg["clip_auxiliary_loss_beta"],
             **aux_betas_from_loss_cfg(loss_cfg)}

    def loss_fn(params, batch, kl_beta):
        m = jmodel.apply(params, batch, kl_beta, False, n_vis,
                         rngs={"sample": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)})
        m["loss"] = m["total_loss"] + sum(b * m[k] for k, b in betas.items() if k in m)
        return m["loss"], m

    @jax.jit
    def step(params, opt_state, batch, noise, kl_beta):
        holder["n"] = noise
        (_, m), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch, kl_beta)
        updates, opt_state = tx.update(grads, opt_state, params)
        m["grad_norm"] = jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree_util.tree_leaves(grads)))
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state, m

    return tx, step


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_three_train_steps_track_jax(monkeypatch, case):
    """Three fused batches at the ``rand_shift`` sizes: the port's train step
    (its optimizer, schedule and clipping from the config) against JAX's
    (``optim.make_optimizer``, the trainer's four aux betas and the CLIP
    beta), same weights, offsets and plan noise: every metric JAX reports,
    the loss and the gradient norm, rtol 1e-3."""
    root, overrides = TRAIN_CASES[case]
    _narrow_posteriors(monkeypatch)
    holder = _install_noise(monkeypatch)
    cfg = cfg_lib.compose(root, SMALL + overrides)
    jmodel, params, tmodel = build_pair(cfg, seed=len(case))
    tx, jstep = _jax_train_step(jmodel, cfg, holder)
    opt_state = tx.init(params)
    mc = cfg["model"]
    opt = make_optimizer(tmodel.parameters(), mc["optimizer"])
    tstep = make_train_step(tmodel, opt, _transform(cfg), cfg["loss"]["clip_auxiliary_loss_beta"],
                            aux_betas_from_loss_cfg(cfg["loss"]), device="cpu",
                            scheduler=make_scheduler(opt, mc["optimizer"], mc.get("lr_scheduler"),
                                                     ESTIMATED_TOTAL),
                            gradient_clip_norm=mc["optimizer"].get("gradient_clip_norm"))
    rng = np.random.default_rng(100 + len(case))
    kl_beta = cfg["loss"]["kl_beta"]
    for i in range(3):
        fused = _fused_batch(rng, cfg)
        b, s = fused["actions"].shape[:2]
        offsets, noise = _offsets(rng, b * s), _noise(rng, cfg, b)
        tbatch = {k: torch.from_numpy(v) for k, v in fused.items()}
        robot = _transform(cfg)(tbatch, None, shift_draws(offsets))
        params, opt_state, want = jstep(params, opt_state,
                                        _jax_batch(fused, offsets, robot["robot_obs"].numpy()),
                                        jnp.asarray(noise), kl_beta)
        got = tstep(tbatch, None, kl_beta, gumbel=torch.from_numpy(noise),
                    draws=shift_draws(offsets))
        assert set(want) - {"loss", "grad_norm"} <= set(got), sorted(set(want) - set(got))
        for name, w in want.items():
            np.testing.assert_allclose(float(got[name]), float(w), rtol=1e-3, atol=1e-5,
                                       err_msg=f"{case} step {i} {name}")


def test_gcbc_and_aux_heads_shape_the_model():
    """GCBC keeps the posterior (the CLIP loss reads its seq_feat) with no
    plan and no KL; the aux heads' metrics exist only with their flags; the
    deterministic decoder builds and is refused by name where JAX's Hulc2
    fails."""
    gcbc = build_policy(cfg_lib.compose("cfg_gcbc", SMALL + AUX)["model"], gripper_hw=84,
                        static_hw=200)
    assert not gcbc.use_plan and gcbc.plan_recognition is not None
    assert gcbc.action_decoder.rnn.weight_ih_l0.shape[1] == 64 + 8  # no plan in its input
    assert gcbc.init_carry(3).plan.shape == (3, 0)
    for head in ("state_decoder", "bcz_lang_decoder", "mia_discriminator"):
        assert getattr(gcbc, head) is not None
    no_clip = build_policy(cfg_lib.compose("cfg_low_level", SMALL + [
        "model.use_clip_auxiliary_loss=false"])["model"], gripper_hw=84, static_hw=200)
    assert no_clip.proj_vis_lang is None and not hasattr(no_clip, "logit_scale")
    det = build_policy(cfg_lib.compose("cfg_low_level", SMALL + [
        "model/action_decoder=deterministic"])["model"], gripper_hw=84, static_hw=200)
    assert isinstance(det.action_decoder, decoders.DeterministicDecoder)
    with pytest.raises(NotImplementedError, match="deterministic"):
        det.policy_step({}, torch.zeros(2, 1, 15), {}, det.init_carry(2))


def test_override_creates_only_the_optional_keys():
    """The aux flags and the clip norm are created by an override, as JAX
    creates them; any other missing key still raises."""
    from hulc2_tpu.core import config as jax_cfg_lib

    ov = AUX + ["model.optimizer.gradient_clip_norm=0.5", "model.lang_task_classes=6",
                "model.use_lang_task_auxiliary_loss=true"]
    assert cfg_lib.compose("cfg_gcbc", ov) == jax_cfg_lib.compose("cfg_gcbc", ov)
    for bad in ("model.use_state_recon=true", "model.optimizer.clip_norm=1",
                "model.action_decoder.gradient_clip_norm=1"):
        with pytest.raises(KeyError):
            cfg_lib.compose("cfg_gcbc", [bad])


# ---- rollouts -------------------------------------------------------------- #
ROLLOUT_CASES = {
    "rnn": ("cfg_low_level", []),
    "gru": ("cfg_low_level", ["model.action_decoder.rnn_model=gru_decoder"]),
    "lstm": ("cfg_low_level", ["model.action_decoder.rnn_model=lstm_decoder",
                               "model/distribution=continuous",
                               "model.distribution.plan_features=12"]),
    "gcbc": ("cfg_gcbc", []),
}
REPLAN = 4


def _jax_reset_slot(carry, i):
    return carry._replace(
        plan=carry.plan.at[i].set(0.0), latent_goal=carry.latent_goal.at[i].set(0.0),
        hidden=jax.tree_util.tree_map(lambda h: h.at[:, i].set(0.0), carry.hidden),
        step=carry.step.at[i].set(0))


@pytest.mark.parametrize("case", list(ROLLOUT_CASES))
def test_policy_step_rollout_with_reset_matches_jax(monkeypatch, case):
    """3 envs over 2 replan periods (replan_freq 4, 9 steps), env 1 restarted
    through ``Hulc2Agent.reset_env_slot`` after step 5: actions atol 1e-5,
    the carry's plan, goal and every hidden tensor atol 1e-5 and fp32."""
    from hulc2_tpu.models.hulc2 import Hulc2 as JaxHulc2
    from hulc2_tpu.ops import logistic

    root, overrides = ROLLOUT_CASES[case]
    holder = _install_noise(monkeypatch)

    def mixture_sample(rng, logit_probs, log_scales, means):
        gumbel = logit_probs - jnp.log(-jnp.log(holder["u_sel"]))
        sel = jax.nn.one_hot(jnp.argmax(gumbel, axis=-1), logit_probs.shape[-1], dtype=means.dtype)
        u = holder["u"]
        return (jnp.sum(sel * means, axis=-1)
                + jnp.exp(jnp.sum(sel * log_scales, axis=-1)) * (jnp.log(u) - jnp.log(1.0 - u)))

    monkeypatch.setattr(logistic, "logistic_mixture_sample", mixture_sample)
    cfg = cfg_lib.compose(root, SMALL + overrides + [f"model.replan_freq={REPLAN}"])
    jmodel, params, tmodel = build_pair(cfg, seed=30 + len(case))
    tmodel.eval()
    agent = Hulc2Agent(tmodel, cfg["datamodule"], n_envs=3)

    @jax.jit
    def jstep(params, rgb, robot_raw, lang, carry, n, u_sel, u):
        holder.update(n=n, u_sel=u_sel, u=u)
        return jmodel.apply(params, rgb, {}, robot_raw[..., :8], robot_raw, {"lang": lang}, carry,
                            rngs={"sample": jax.random.PRNGKey(0)}, method=JaxHulc2.policy_step)

    b, k = 3, cfg["model"]["action_decoder"]["n_mixtures"]
    rng = np.random.default_rng(31)
    lang = rng.standard_normal((b, EMB_DIM)).astype(np.float32)
    jcarry = jmodel.init_carry(b)
    for t in range(2 * REPLAN + 1):
        if t == 6:
            jcarry = _jax_reset_slot(jcarry, 1)
            agent.reset_env_slot(1)
        rgb = {cam: (rng.integers(0, 256, (b, 1, hw, hw, 3)) / 127.5 - 1.0).astype(np.float32)
               for cam, hw in SIZES.items()}
        robot = (rng.standard_normal((b, 1, 15)) * 0.3).astype(np.float32)
        noise = _noise(rng, cfg, b)
        u_sel = rng.uniform(R1, R2, (b, 1, 6, k)).astype(np.float32)
        u = rng.uniform(R1, R2, (b, 1, 6)).astype(np.float32)
        want, jcarry = jstep(params, {c: jnp.asarray(v) for c, v in rgb.items()}, jnp.asarray(robot),
                             jnp.asarray(lang), jcarry, *map(jnp.asarray, (noise, u_sel, u)))
        continuous = cfg["model"]["distribution"]["dist"] == "continuous"
        draws = PolicyDraws(None if continuous else torch.from_numpy(noise),
                            torch.from_numpy(u_sel), torch.from_numpy(u),
                            torch.from_numpy(noise) if continuous else None)
        with torch.inference_mode():
            got, agent.carry = tmodel.policy_step({c: torch.from_numpy(v) for c, v in rgb.items()},
                                                  torch.from_numpy(robot),
                                                  {"lang": torch.from_numpy(lang)}, agent.carry,
                                                  draws=draws)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=f"step {t}")
        carry = agent.carry
        for name in ("plan", "latent_goal"):
            _close(getattr(carry, name), getattr(jcarry, name), f"step {t} {name}", atol=1e-5)
        hidden = jax.tree_util.tree_leaves(carry.hidden)
        assert len(hidden) == (2 if case == "lstm" else 1)
        for g, w in zip(hidden, jax.tree_util.tree_leaves(jcarry.hidden)):
            assert g.dtype == torch.float32
            _close(g, w, f"step {t} hidden", atol=1e-5)
    assert agent.carry.step.tolist() == [9, 3, 9]
    assert agent.carry.plan.shape[1] == (0 if case == "gcbc" else tmodel.dist.plan_features)
