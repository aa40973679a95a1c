"""The port's rollout path against the JAX package's, on the CPU at small width.

The sampler, the TCP-to-world conversion, the ReLU RNN from a given state,
``policy_step`` over 35 steps across a replan boundary with a per-env reset,
the fused render+policy step and the device renderer. Both sides get the same
numpy-made inputs and the same random draws: on the JAX side the plan sampler
and the mixture sampler are swapped for versions that take the draws, as
``install_gumbel_rsample`` does for training.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port_common import SIZES, build_both, small_config
from hulc2_torch.data.device_transforms import make_batch_transform
from hulc2_torch.envs.render_torch import make_render_obs_fn
from hulc2_torch.models.hulc2 import PolicyDraws
from hulc2_torch.models.layers import ReluRNN
from hulc2_torch.ops.gripper_frame import tcp_to_world_frame
from hulc2_torch.ops.logistic import logistic_mixture_sample
from hulc2_torch.train.steps import make_fused_render_policy_step

R1, R2 = 1e-5, 1.0 - 1e-5


def install_policy_samplers(monkeypatch) -> dict:
    """Swap the JAX plan sampler and mixture sampler for the same math with
    the draws in the returned holder ("g", "u_sel", "u")."""
    from hulc2_tpu.models.distributions import PlanDistribution
    from hulc2_tpu.ops import logistic

    holder = {}

    def sample(self, rng, state):
        logits = self._logits(state)
        idx = jnp.argmax(logits + holder["g"], axis=-1)
        one_hot = jax.nn.one_hot(idx, self.class_size, dtype=logits.dtype)
        return one_hot.reshape(*one_hot.shape[:-2], -1)

    def mixture_sample(rng, logit_probs, log_scales, means):
        gumbel = logit_probs - jnp.log(-jnp.log(holder["u_sel"]))
        sel = jax.nn.one_hot(jnp.argmax(gumbel, axis=-1), logit_probs.shape[-1], dtype=means.dtype)
        log_scale = jnp.sum(sel * log_scales, axis=-1)
        mean = jnp.sum(sel * means, axis=-1)
        u = holder["u"]
        return mean + jnp.exp(log_scale) * (jnp.log(u) - jnp.log(1.0 - u))

    monkeypatch.setattr(PlanDistribution, "sample", sample)
    monkeypatch.setattr(logistic, "logistic_mixture_sample", mixture_sample)
    return holder


def make_draws(rng: np.random.Generator, cfg: dict, b: int) -> dict:
    d, ad = cfg["model"]["distribution"], cfg["model"]["action_decoder"]
    a, k = ad["out_features"] - 1, ad["n_mixtures"]
    return {"g": rng.gumbel(size=(b, d["category_size"], d["class_size"])).astype(np.float32),
            "u_sel": rng.uniform(R1, R2, (b, 1, a, k)).astype(np.float32),
            "u": rng.uniform(R1, R2, (b, 1, a)).astype(np.float32)}


def torch_draws(draws: dict) -> PolicyDraws:
    return PolicyDraws(*(torch.from_numpy(draws[k]) for k in ("g", "u_sel", "u")))


def random_tokens(rng: np.random.Generator, b: int) -> np.ndarray:
    toks = np.zeros((b, 77), np.int32)
    for i in range(b):
        n = int(rng.integers(4, 12))
        toks[i, 0], toks[i, n - 1] = 49406, 49407
        toks[i, 1:n - 1] = rng.integers(1, 49000, n - 2)
    return toks


def robot_states(rng: np.random.Generator, b: int) -> np.ndarray:
    robot = rng.standard_normal((b, 15)).astype(np.float32) * 0.3
    robot[:, 3:6] = rng.uniform(-3, 3, (b, 3))
    robot[:, 14] = rng.choice([-1.0, 1.0], b)
    return robot


class TestSamplerAndFrames:
    def test_sampler_matches_jax(self):
        """The JAX sampler as it is, with its own keys; the port gets the
        uniforms those keys draw. rtol 1e-5 / atol 1e-6 (fp32 exp and log)."""
        from hulc2_tpu.ops import logistic

        rng = np.random.default_rng(0)
        shape = (5, 3, 6, 10)
        lp, ls, mu = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
        ls = np.maximum(ls, -7.0)
        key = jax.random.PRNGKey(7)
        want = np.asarray(logistic.logistic_mixture_sample(key, lp, ls, mu))
        k_sel, k_inv = jax.random.split(key)
        u_sel = np.array(jax.random.uniform(k_sel, shape, minval=R1, maxval=R2))
        u = np.array(jax.random.uniform(k_inv, shape[:-1], minval=R1, maxval=R2))
        got = logistic_mixture_sample(*(torch.from_numpy(x) for x in (lp, ls, mu)),
                                      torch.from_numpy(u_sel), torch.from_numpy(u))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    def test_sampler_draws_from_generator(self):
        shape = (4, 6, 10)
        lp, ls, mu = torch.zeros(shape), torch.full(shape, -2.0), torch.zeros(shape)
        a = logistic_mixture_sample(lp, ls, mu, generator=torch.Generator().manual_seed(1))
        b = logistic_mixture_sample(lp, ls, mu, generator=torch.Generator().manual_seed(1))
        assert a.shape == (4, 6) and torch.equal(a, b) and torch.isfinite(a).all()
        with pytest.raises(ValueError):
            logistic_mixture_sample(lp, ls, mu)

    def test_tcp_to_world_matches_jax(self):
        from hulc2_tpu.ops.gripper_frame import tcp_to_world_frame as jax_tcp_to_world

        rng = np.random.default_rng(1)
        action = rng.uniform(-1, 1, (4, 3, 7)).astype(np.float32)
        robot = rng.uniform(-3, 3, (4, 3, 15)).astype(np.float32)
        want = np.asarray(jax_tcp_to_world(jnp.asarray(action), jnp.asarray(robot)))
        got = tcp_to_world_frame(torch.from_numpy(action), torch.from_numpy(robot)).numpy()
        # positions and gripper: a 3x3 rotation in fp32, atol 1e-5
        np.testing.assert_allclose(got[..., [0, 1, 2, 6]], want[..., [0, 1, 2, 6]], atol=1e-5)
        # orientations are an fp32 angle difference divided by 0.01: one ulp of
        # a 3-rad angle is 2.4e-5 there, so they get the 2e-4 of the
        # world-to-TCP test (tests/test_torch_port_ops.py)
        np.testing.assert_allclose(got[..., 3:6], want[..., 3:6], atol=2e-4, rtol=1e-5)

    def test_relu_rnn_from_h0_matches_jax(self):
        """Both stacks from the same weights and initial state: atol 1e-5."""
        from hulc2_tpu.models.layers import ReluRNN as JaxReluRNN

        rng = np.random.default_rng(2)
        x = rng.standard_normal((3, 4, 10)).astype(np.float32)
        h0 = rng.standard_normal((2, 3, 16)).astype(np.float32)
        jrnn = JaxReluRNN(16, 2)
        params = jrnn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(h0))
        want_y, want_h = jrnn.apply(params, jnp.asarray(x), jnp.asarray(h0))
        trnn = ReluRNN(10, 16, 2)
        p = params["params"]
        with torch.no_grad():
            for k in range(2):
                for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                    leaf = np.array(p[f"{name}_l{k}"])
                    kind = "weight" if name[0] == "w" else "bias"
                    getattr(trnn, f"{kind}_{name[2:]}_l{k}").copy_(
                        torch.from_numpy(leaf.T.copy() if kind == "weight" else leaf))
        got_y, got_h = trnn(torch.from_numpy(x), torch.from_numpy(h0))
        np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(want_y), atol=1e-5)
        np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h), atol=1e-5)


@pytest.fixture(scope="module")
def both_models():
    cfg = small_config()
    jmodel, params, tmodel = build_both(cfg, seed=3)
    return cfg, jmodel, params, tmodel.eval()


def _jax_policy_step_fn(jmodel, holder):
    from hulc2_tpu.models.hulc2 import Hulc2 as JaxHulc2

    @jax.jit
    def step(params, rgb, robot_raw, lang, carry, g, u_sel, u):
        holder.update(g=g, u_sel=u_sel, u=u)
        return jmodel.apply(params, rgb, {}, robot_raw[..., :8], robot_raw, {"lang": lang}, carry,
                            rngs={"sample": jax.random.PRNGKey(0)}, method=JaxHulc2.policy_step)

    return step


def _jax_reset_slot(carry, i):
    return carry._replace(plan=carry.plan.at[i].set(0.0), latent_goal=carry.latent_goal.at[i].set(0.0),
                          hidden=carry.hidden.at[:, i].set(0.0), step=carry.step.at[i].set(0))


class TestPolicyStep:
    def test_policy_step_35_steps_with_reset_matches_jax(self, monkeypatch, both_models):
        """35 steps of 3 envs (replan at 0 and 30), env 1 restarted at step
        12. Actions and hidden state atol 1e-4 (fp32, 35 chained steps),
        plan and step counters exact."""
        holder = install_policy_samplers(monkeypatch)
        cfg, jmodel, params, tmodel = both_models
        jstep = _jax_policy_step_fn(jmodel, holder)
        b = 3
        rng = np.random.default_rng(4)
        lang = random_tokens(rng, b)
        jcarry = jmodel.init_carry(b)
        tcarry = tmodel.init_carry(b, "cpu")
        for t in range(35):
            if t == 12:
                jcarry = _jax_reset_slot(jcarry, 1)
                with torch.inference_mode():
                    for x in (tcarry.plan, tcarry.latent_goal, tcarry.step):
                        x[1] = 0
                    tcarry.hidden[:, 1] = 0
            rgb = {cam: (rng.integers(0, 256, (b, 1, hw, hw, 3)) / 127.5 - 1.0).astype(np.float32)
                   for cam, hw in SIZES.items()}
            robot = robot_states(rng, b)[:, None]
            draws = make_draws(rng, cfg, b)
            want, jcarry = jstep(params, {k: jnp.asarray(v) for k, v in rgb.items()},
                                 jnp.asarray(robot), jnp.asarray(lang), jcarry,
                                 *(jnp.asarray(draws[k]) for k in ("g", "u_sel", "u")))
            with torch.inference_mode():
                got, tcarry = tmodel.policy_step({k: torch.from_numpy(v) for k, v in rgb.items()},
                                                 torch.from_numpy(robot), {"lang": torch.from_numpy(lang)},
                                                 tcarry, draws=torch_draws(draws))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=f"step {t}")
            np.testing.assert_array_equal(tcarry.plan.numpy(), np.asarray(jcarry.plan))
            np.testing.assert_array_equal(tcarry.step.numpy(), np.asarray(jcarry.step))
            np.testing.assert_allclose(tcarry.hidden.numpy(), np.asarray(jcarry.hidden), atol=1e-4)
            np.testing.assert_allclose(tcarry.latent_goal.numpy(), np.asarray(jcarry.latent_goal),
                                       atol=1e-4)
        assert tcarry.step.tolist() == [35, 23, 35]

    def test_visual_goal_step_matches_jax(self, monkeypatch, both_models):
        """The visual-goal branch of one step: goal frames through the
        perceptual encoder and the visual goal net."""
        from hulc2_tpu.models.hulc2 import Hulc2 as JaxHulc2

        holder = install_policy_samplers(monkeypatch)
        cfg, jmodel, params, tmodel = both_models
        b = 2
        rng = np.random.default_rng(5)
        rgb, goal = ({cam: (rng.integers(0, 256, (b, 1, hw, hw, 3)) / 127.5 - 1.0).astype(np.float32)
                      for cam, hw in SIZES.items()} for _ in range(2))
        robot = robot_states(rng, b)[:, None]
        draws = make_draws(rng, cfg, b)
        holder.update({k: jnp.asarray(v) for k, v in draws.items()})
        want, _ = jmodel.apply(params, {k: jnp.asarray(v) for k, v in rgb.items()}, {},
                               jnp.asarray(robot[..., :8]), jnp.asarray(robot),
                               {"rgb_obs": {k: jnp.asarray(v) for k, v in goal.items()},
                                "depth_obs": {}}, jmodel.init_carry(b),
                               rngs={"sample": jax.random.PRNGKey(0)}, method=JaxHulc2.policy_step)
        with torch.inference_mode():
            got, _ = tmodel.policy_step({k: torch.from_numpy(v) for k, v in rgb.items()},
                                        torch.from_numpy(robot),
                                        {"rgb_obs": {k: torch.from_numpy(v) for k, v in goal.items()}},
                                        tmodel.init_carry(b, "cpu"), draws=torch_draws(draws))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    def test_step_draws_from_generator(self, both_models):
        cfg, _, _, tmodel = both_models
        b = 2
        rng = np.random.default_rng(6)
        rgb = {cam: torch.from_numpy((rng.integers(0, 256, (b, 1, hw, hw, 3)) / 127.5 - 1.0)
                                     .astype(np.float32)) for cam, hw in SIZES.items()}
        robot = torch.from_numpy(robot_states(rng, b)[:, None])
        goal = {"lang": torch.from_numpy(random_tokens(rng, b))}
        with torch.inference_mode():
            acts = [tmodel.policy_step(rgb, robot, goal, tmodel.init_carry(b, "cpu"),
                                       torch.Generator().manual_seed(3))[0] for _ in range(2)]
        assert torch.equal(acts[0], acts[1]) and acts[0].abs().max() <= 1.0


    def test_agent_steps_a_farm(self, both_models):
        """The agent on the host-render path: a farm's stacked frames, a
        language goal and a visual goal, one env restarted, one-env obs."""
        from hulc2_torch.agents.hulc2_agent import Hulc2Agent
        from hulc2_torch.envs.calvin_wrapper import EnvFarm
        from hulc2_torch.envs.fake_env import FakeCalvinEnv

        cfg, _, _, tmodel = both_models
        farm = EnvFarm([FakeCalvinEnv(static_hw=96, gripper_hw=64) for _ in range(2)])
        agent = Hulc2Agent(tmodel, cfg["datamodule"], n_envs=2)
        obs = farm.reset()
        lang = random_tokens(np.random.default_rng(9), 1)[0]
        act = agent.step(obs, {"lang": lang})
        assert act.shape == (2, 7) and np.abs(act).max() <= 1.0
        assert set(np.abs(act[:, -1]).tolist()) == {1.0}
        assert agent.step(obs, agent.make_visual_goal(obs)).shape == (2, 7)
        agent.reset_env_slot(1)
        assert agent.carry.step.tolist() == [2, 0]
        single = Hulc2Agent(tmodel, cfg["datamodule"], n_envs=1)
        assert single.step(farm.envs[0].get_obs(), {"lang": lang}).shape == (7,)


def _scene_states(n: int, seed: int):
    """Initial states of the evaluation chains with perturbed robot poses."""
    from hulc2_torch.tools.profile_eval import perturbed_states

    return perturbed_states(n, seed)


class TestFusedRenderStep:
    def test_fused_render_policy_step_matches_jax(self, monkeypatch, both_models):
        """Render (K=3 envs) -> val transform -> policy step -> binarized
        gripper, 3 steps with the carry: atol 1e-4."""
        from hulc2_tpu.data.device_transforms import make_batch_transform as jax_transform
        from hulc2_tpu.data.statistics import DatasetStatistics
        from hulc2_tpu.envs.render_jax import make_render_obs_fn as jax_render_fn
        from hulc2_tpu.train.steps import make_fused_render_policy_step as jax_fused

        holder = install_policy_samplers(monkeypatch)
        cfg, jmodel, params, tmodel = both_models
        dm = cfg["datamodule"]
        k = 3
        keys = sorted(dm["observation_space"]["rgb_obs"])
        jtf = jax_transform(dm["observation_space"], dm["proprioception_dims"], DatasetStatistics(),
                            dm["transforms"], train=False)
        jfn = jax_fused(jmodel, jtf, jax_render_fn(96, 64, with_depth=False), keys, [])
        ttf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                   dm["transforms"], train=False)
        tfn = make_fused_render_policy_step(tmodel, ttf, make_render_obs_fn(96, 64, with_depth=False, device="cpu"),
                                            keys)
        rng = np.random.default_rng(7)
        lang = random_tokens(rng, k)
        scenes, robots = _scene_states(3 * k, seed=8)
        jcarry, tcarry = jmodel.init_carry(k), tmodel.init_carry(k, "cpu")
        for t in range(3):
            state = {"robot_obs": robots[t * k:(t + 1) * k], "scene_obs": scenes[t * k:(t + 1) * k]}
            draws = make_draws(rng, cfg, k)
            holder.update({n: jnp.asarray(v) for n, v in draws.items()})
            with jax.disable_jit():  # the swapped samplers read the draws when traced
                want, jcarry = jfn(params, {n: jnp.asarray(v) for n, v in state.items()},
                                   {"lang": jnp.asarray(lang)}, jcarry, jax.random.PRNGKey(0), t)
            got, tcarry = tfn({n: torch.from_numpy(v) for n, v in state.items()},
                              {"lang": torch.from_numpy(lang)}, tcarry, None, torch_draws(draws))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=f"step {t}")
            assert set(np.abs(got.numpy()[:, -1]).tolist()) == {1.0}


class TestRenderer:
    """The bounds of ``tests/test_render_jax.py``: no pixel off by more than
    one LSB, fewer than 1e-4 of them off at all, depth within 1e-5."""

    @staticmethod
    def _assert_close_frames(ref, got, what):
        diff = np.abs(ref.astype(int) - got.astype(int))
        assert (diff > 1).mean() == 0.0, what
        assert (diff != 0).mean() < 1e-4, (what, (diff != 0).mean())

    @pytest.mark.parametrize("hw", [(96, 64), (64, 48)])
    def test_matches_jax_and_host_renderers(self, hw):
        from test_render_jax import random_states
        from hulc2_tpu.envs.render_jax import make_render_obs_fn as jax_render_fn

        scenes, robots, refs = random_states(6, seed=1, static_hw=hw[0], gripper_hw=hw[1])
        got = make_render_obs_fn(*hw, device="cpu")(torch.from_numpy(scenes), torch.from_numpy(robots))
        want = jax.jit(jax_render_fn(*hw))(scenes, robots)
        for key in ("rgb_static", "rgb_gripper"):
            host = np.stack([r["rgb_obs"][key] for r in refs])
            self._assert_close_frames(host, got[key].numpy(), ("host", key))
            self._assert_close_frames(np.asarray(want[key]), got[key].numpy(), ("jax", key))
        host_depth = np.stack([r["depth_obs"]["depth_static"] for r in refs])
        assert np.abs(host_depth - got["depth_static"].numpy()).max() < 1e-5
        assert np.abs(np.asarray(want["depth_static"]) - got["depth_static"].numpy()).max() < 1e-5

    def test_matches_jax_on_eval_states(self):
        """The evaluation chains' initial states with perturbed robot poses,
        the states the card check renders. Against the host renderer the JAX
        raycaster itself flips a pixel at a box edge on these states (float64
        intermediates), so the reference here is the JAX raycaster."""
        from hulc2_tpu.envs.render_jax import make_render_obs_fn as jax_render_fn

        scenes, robots = _scene_states(16, seed=2)
        got = make_render_obs_fn(96, 64, device="cpu")(torch.from_numpy(scenes), torch.from_numpy(robots))
        want = jax.jit(jax_render_fn(96, 64))(scenes, robots)
        for key in ("rgb_static", "rgb_gripper"):
            self._assert_close_frames(np.asarray(want[key]), got[key].numpy(), key)
        assert np.abs(np.asarray(want["depth_static"]) - got["depth_static"].numpy()).max() < 1e-5

    def test_drawer_cavity_toggles(self):
        from hulc2_torch.envs.fake_env import FakeCalvinEnv

        env = FakeCalvinEnv(static_hw=96, gripper_hw=64)
        fn = make_render_obs_fn(96, 64, device="cpu")
        for s1 in (0.0, 0.01, 0.05, 0.22):
            env.reset()
            env.scene_obs[1] = s1
            ref = env.get_obs()["rgb_obs"]["rgb_static"]
            out = fn(torch.from_numpy(env.scene_obs[None].astype(np.float32)),
                     torch.from_numpy(env.robot_obs[None].astype(np.float32)))["rgb_static"][0]
            self._assert_close_frames(ref, out.numpy(), s1)

    def test_no_depth_variant(self):
        scenes, robots = _scene_states(2, seed=3)
        out = make_render_obs_fn(96, 64, with_depth=False, device="cpu")(torch.from_numpy(scenes),
                                                           torch.from_numpy(robots))
        assert set(out) == {"rgb_static", "rgb_gripper"}
        assert out["rgb_static"].shape == (2, 96, 96, 3) and out["rgb_static"].dtype == torch.uint8
