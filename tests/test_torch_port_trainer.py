"""The port's validation, trainer and the disk-to-evaluation chain, on the CPU.

``val_forward`` metrics against the JAX package's with the same draws; three
train steps from the device-store loader (on the CPU) against the JAX step on
the same fused batches, crop offsets and Gumbel draws; the trainer's
checkpoint round trip, auto-resume and preemption save; and the three
commands of the main path at tiny width: generate a dataset, train on it,
evaluate the trained run.
"""
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port_common import (
    PADS, SMALL_OVERRIDES, _jax_shift_normalize, build_both, install_gumbel_rsample,
    jax_train_step_fn, make_draws, make_raw_batch, shift_draws, small_config, torch_raw,
)
from _torch_port_dataset import write_calvin_dir
from hulc2_torch import training
from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.core.checkpoint import CheckpointManager
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.data.device_transforms import make_batch_transform
from hulc2_torch.data.statistics import load_statistics
from hulc2_torch.models.hulc2 import PolicyDraws
from hulc2_torch.train import trainer as trainer_mod
from hulc2_torch.train.optim import make_optimizer
from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step, make_val_step

R1, R2 = 1e-5, 1.0 - 1e-5
TINY = [
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.visual_goal.hidden_size=32",
    "model.language_goal.hidden_size=32", "model.action_decoder.hidden_size=32",
    "model.language_encoder.width=32", "model.language_encoder.heads=2",
]


@pytest.fixture(scope="module")
def calvin96(tmp_path_factory):
    """The fixture dataset at the flagship's 96 / 64 pixel frames."""
    return write_calvin_dir(tmp_path_factory.mktemp("calvin96"), static_hw=96, gripper_hw=64)


def disk_config(root, *extra) -> dict:
    """The small parity config reading ``root``: windows of 3-4 frames,
    batches of 2 + 2, two steps per epoch, one val batch, a line per step;
    the task head covers the dataset's task ids."""
    return flagship_config(list(SMALL_OVERRIDES) + [
        f"datamodule.root_data_dir={root}", "datamodule.min_window_size=3",
        "model.lang_task_classes=34",
        "datamodule.num_workers=2", "trainer.log_every_n_steps=1",
        "trainer.limit_train_batches=2", "trainer.limit_val_batches=1", *extra])


def _proprio_stats(root, split):
    from hulc2_tpu.data.statistics import load_statistics as jax_load

    return load_statistics(root / split), jax_load(root / split)


def install_val_samplers(monkeypatch) -> dict:
    """The JAX plan sampler and mixture sampler with the draws taken, in call
    order, from the lists in the returned holder ("g", "u_sel", "u")."""
    from hulc2_tpu.models.distributions import PlanDistribution
    from hulc2_tpu.ops import logistic

    holder = {}

    def sample(self, rng, state):
        logits = self._logits(state)
        idx = jnp.argmax(logits + holder["g"].pop(0), axis=-1)
        one_hot = jax.nn.one_hot(idx, self.class_size, dtype=logits.dtype)
        return one_hot.reshape(*one_hot.shape[:-2], -1)

    def mixture_sample(rng, logit_probs, log_scales, means):
        gumbel = logit_probs - jnp.log(-jnp.log(holder["u_sel"].pop(0)))
        sel = jax.nn.one_hot(jnp.argmax(gumbel, axis=-1), logit_probs.shape[-1], dtype=means.dtype)
        log_scale = jnp.sum(sel * log_scales, axis=-1)
        mean = jnp.sum(sel * means, axis=-1)
        u = holder["u"].pop(0)
        return mean + jnp.exp(log_scale) * (jnp.log(u) - jnp.log(1.0 - u))

    monkeypatch.setattr(PlanDistribution, "sample", sample)
    monkeypatch.setattr(logistic, "logistic_mixture_sample", mixture_sample)
    return holder


def test_val_forward_matches_jax(monkeypatch, calvin96):
    """The val step (val transform with the validation split's statistics,
    then ``val_forward``) against the JAX val transform and ``val_forward``,
    same weights, batch and draws: every metric to rtol 1e-4."""
    import hulc2_tpu.data.device_transforms as jdt
    from hulc2_tpu.models.hulc2 import Hulc2 as JaxHulc2

    holder = install_val_samplers(monkeypatch)
    cfg = small_config()
    jmodel, params, tmodel = build_both(cfg, seed=2)
    dm = cfg["datamodule"]
    stats, jstats = _proprio_stats(calvin96, "validation")
    rng = np.random.default_rng(8)
    raw = make_raw_batch(rng, cfg)
    b, s = 4, dm["max_window_size"]
    d, ad = cfg["model"]["distribution"], cfg["model"]["action_decoder"]
    a, k = ad["out_features"] - 1, ad["n_mixtures"]
    draws = {tag: {"g": rng.gumbel(size=(b, d["category_size"], d["class_size"])).astype(np.float32),
                   "u_sel": rng.uniform(R1, R2, (b, s, a, k)).astype(np.float32),
                   "u": rng.uniform(R1, R2, (b, s, a)).astype(np.float32)}
             for tag in ("pp", "pr")}

    jtf = jdt.make_batch_transform(dm["observation_space"], dm["proprioception_dims"], jstats,
                                   "rand_shift_96", train=False)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def jax_val(params, raw, draws):
        holder.update({name: [draws[t][name] for t in ("pp", "pr")] for name in ("g", "u_sel", "u")})
        batch = {m: jtf(key, raw[m]) for m in raw}
        return jmodel.apply(params, batch, 0.01, rngs={"sample": key}, method=JaxHulc2.val_forward)

    want = jax_val(params, raw, draws)

    tf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"], "rand_shift_96",
                              train=False, stats=stats)
    tdraws = {t: PolicyDraws(*(torch.from_numpy(draws[t][n]) for n in ("g", "u_sel", "u")))
              for t in draws}
    got = make_val_step(tmodel, tf)(torch_raw(raw), None, 0.01, tdraws)
    assert set(got) == set(want)
    assert len(got) == 2 * 2 * 5 + 2 + 1
    for name, w in want.items():
        np.testing.assert_allclose(float(got[name]), float(w), rtol=1e-4, atol=1e-6, err_msg=name)


def _jax_fused_batch(fused: dict, offsets: dict, jstats, proprio_cfg) -> dict:
    from hulc2_tpu.data.device_transforms import process_proprio as jprocess

    return {
        "rgb_obs": {cam: _jax_shift_normalize(jnp.asarray(fused[cam]), jnp.asarray(offsets[cam]), pad)
                    for cam, pad in PADS.items()},
        "depth_obs": {},
        "robot_obs": jprocess(jnp.asarray(fused["robot_obs_raw"]), jstats, proprio_cfg),
        "robot_obs_raw": jnp.asarray(fused["robot_obs_raw"]),
        "actions": jnp.asarray(fused["actions"]),
        "lang": jnp.asarray(fused["lang"]),
        "use_for_aux_lang_loss": jnp.asarray(fused["use_for_aux_lang_loss"]),
        "lang_task_id": jnp.asarray(fused["lang_task_id"]),
    }


def test_three_disk_train_steps_track_jax(monkeypatch, calvin96):
    """Three fused batches from the device-store loader, with the training
    split's statistics: the port's step on them against the JAX step on the
    same arrays, offsets and Gumbel draws, losses to rtol 1e-3."""
    holder = install_gumbel_rsample(monkeypatch)
    cfg = disk_config(calvin96)
    dm_cfg = cfg["datamodule"]
    dm = Hulc2DataModule(dm_cfg, seed=cfg["seed"], device="cpu")
    dm.setup()
    stats, jstats = _proprio_stats(calvin96, "training")
    jmodel, params, tmodel = build_both(cfg, seed=1)
    loss_cfg, lr = cfg["loss"], cfg["model"]["optimizer"]["lr"]
    tx, jstep = jax_train_step_fn(jmodel, lr, loss_cfg["clip_auxiliary_loss_beta"],
                                  loss_cfg["lang_task_auxiliary_loss_beta"],
                                  dm_cfg["batch_size_vis"], holder)
    opt_state = tx.init(params)
    tf = make_batch_transform(dm_cfg["observation_space"], dm_cfg["proprioception_dims"],
                              dm_cfg["transforms"], stats=stats)
    opt = make_optimizer(tmodel.parameters(), cfg["model"]["optimizer"])
    tstep = make_train_step(tmodel, opt, tf, loss_cfg["clip_auxiliary_loss_beta"],
                            aux_betas_from_loss_cfg(loss_cfg), device="cpu")
    rng = np.random.default_rng(5)
    batches = iter(dm.fused_train_iter())
    for i in range(3):
        raw = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in next(batches).items()}
        assert raw["rgb_static"].shape == (4, 4, 96, 96, 3) and raw["lang"].dtype == np.int32
        offsets, gumbel = make_draws(rng, cfg)
        params, opt_state, want = jstep(params, opt_state,
                                        _jax_fused_batch(raw, offsets, jstats,
                                                         dm_cfg["proprioception_dims"]),
                                        jnp.asarray(gumbel), loss_cfg["kl_beta"])
        got = tstep({k: torch.from_numpy(v) for k, v in raw.items()}, None, loss_cfg["kl_beta"],
                    gumbel=torch.from_numpy(gumbel), draws=shift_draws(offsets))
        for name in ("loss", "total_loss", "action_loss", "kl_loss", "lang_clip_loss",
                     "lang_task_loss", "grad_norm"):
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-3, atol=1e-5,
                                       err_msg=f"step {i} {name}")


def _fit(cfg, run_dir, max_epochs=None, max_steps=None):
    dm = Hulc2DataModule(cfg["datamodule"], seed=cfg["seed"], device="cpu")
    dm.setup()
    return trainer_mod.Trainer(cfg, dm, run_dir, device="cpu").fit(max_epochs, max_steps)


def _losses(result):
    return [line["train/loss"] for line in result.history]


class TestTrainer:
    def test_resume_equals_uninterrupted_run(self, calvin96, tmp_path):
        """Two epochs of two steps in one run; the same run stopped after the
        first epoch's checkpoint (step 2) and resumed into a fresh model and
        optimizer: steps 3 and 4 have bit-equal losses, and the final
        parameters are equal."""
        cfg = disk_config(calvin96)
        whole = _fit(cfg, tmp_path / "whole", max_epochs=2)
        assert whole.step == 4 and len(whole.history) == 4 and whole.resumed_from is None
        first = _fit(cfg, tmp_path / "cut", max_epochs=1)
        assert first.step == 2 and _losses(first) == _losses(whole)[:2]
        resumed = _fit(cfg, tmp_path / "cut", max_epochs=2)
        assert resumed.resumed_from == 2 and resumed.step == 4
        assert _losses(resumed) == _losses(whole)[2:]
        want, got = whole.model.state_dict(), resumed.model.state_dict()
        assert all(torch.equal(want[k], got[k]) for k in want)
        assert CheckpointManager(tmp_path / "cut").all_steps() == [2, 4]
        lines = [json.loads(x) for x in (tmp_path / "cut" / "metrics.jsonl").read_text().splitlines()]
        val = [x for x in lines if any(k.startswith("val/") for k in x)]
        assert [x["step"] for x in val] == [2, 4]
        assert all(np.isfinite(v) for x in val for v in x.values())
        perf = [x for x in lines if "perf/samples_per_sec" in x]
        assert len(perf) == 2 and all(x["perf/samples_per_sec"] > 0 for x in perf)
        assert json.loads((tmp_path / "cut" / "config.json").read_text()) == cfg

    def test_sigusr1_saves_at_the_step_edge(self, calvin96, tmp_path, monkeypatch):
        """SIGUSR1 during step 2 of a 3-step epoch: the step finishes, the
        run saves step 2 without validating and stops; the handlers are put
        back afterwards."""
        assert threading.current_thread() is threading.main_thread()
        make = trainer_mod.make_train_step

        def make_signalling(*args, **kwargs):
            step = make(*args, **kwargs)
            calls = []

            def signalling_step(*a, **kw):
                out = step(*a, **kw)
                calls.append(1)
                if len(calls) == 2:
                    os.kill(os.getpid(), signal.SIGUSR1)
                return out

            return signalling_step

        monkeypatch.setattr(trainer_mod, "make_train_step", make_signalling)
        before = signal.getsignal(signal.SIGUSR1)
        result = _fit(disk_config(calvin96, "trainer.limit_train_batches=3"), tmp_path, max_epochs=3)
        assert signal.getsignal(signal.SIGUSR1) is before
        assert result.step == 2 and result.val_history == []
        assert CheckpointManager(tmp_path).all_steps() == [2]
        assert "val/" not in (tmp_path / "metrics.jsonl").read_text()

    def test_checkpoint_manager(self, tmp_path):
        model = torch.nn.Linear(3, 2)
        opt = torch.optim.Adam(model.parameters())
        model(torch.ones(1, 3)).sum().backward()
        opt.step()
        mgr = CheckpointManager(tmp_path, save_top_k=2)
        assert mgr.restore() is None and mgr.latest_step() is None
        for step in (5, 10, 15):
            mgr.save(step, model, opt, {"val/x": torch.tensor(1.5)})
        assert mgr.all_steps() == [10, 15] and mgr.latest_step() == 15
        assert sorted(p.name for p in (tmp_path / "saved_models").iterdir()) == ["10.pt", "15.pt"]
        ck = mgr.restore(10)
        assert ck["step"] == 10 and ck["metrics"] == {"val/x": 1.5}
        assert torch.equal(ck["model"]["weight"], model.weight.detach())
        assert ck["optimizer"]["state"][0]["exp_avg"].shape == (2, 3)
        with pytest.raises(FileNotFoundError):
            mgr.restore(5)

    def test_step_seeds_differ_by_stream_and_step(self):
        seeds = {trainer_mod.step_seed(42, s, k) for s in (0, 1) for k in range(100)}
        assert len(seeds) == 200 and all(0 <= x < 2 ** 63 for x in seeds)
        assert trainer_mod.step_seed(42, 0, 7) == trainer_mod.step_seed(42, 0, 7)


def test_disk_training_refuses_without_cuda(calvin96, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is what a CPU-only host sees")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        training.main(["--run-dir", str(tmp_path), f"datamodule.root_data_dir={calvin96}", *TINY])


def test_main_path_cli_chain_on_cpu(tmp_path, monkeypatch):
    """The three commands of the main path at tiny width on the CPU: the
    port's generator writes a dataset, ``training`` learns from it for two
    epochs, ``evaluate_policy --train-dir`` scores the newest checkpoint."""
    from hulc2_torch.evaluation import evaluate_policy
    from hulc2_torch.evaluation.loading import load_policy
    from hulc2_torch.tools import make_expert_dataset

    monkeypatch.setenv("HULC2_SEQUENCES_CACHE_DIR", str(tmp_path))
    data, run = tmp_path / "data", tmp_path / "run"
    make_expert_dataset.main([str(data), "--episodes", "1", "--tasks-per-episode", "6",
                              "--val-episodes", "1", "--val-tasks-per-episode", "4",
                              "--lang-tokens", "--holdout-paraphrases", "4", "--seed", "0"])
    argv = ["--run-dir", str(run), "--device", "cpu", f"datamodule.root_data_dir={data}", *TINY,
            "datamodule.batch_size_vis=4", "datamodule.batch_size_lang=4", "datamodule.num_workers=2",
            "trainer.log_every_n_steps=1", "trainer.limit_train_batches=2",
            "trainer.limit_val_batches=1"]
    first = training.main(argv + ["--max-epochs", "1"])
    result = training.main(argv + ["--max-epochs", "2"])
    assert first.step == 2 and result.resumed_from == 2 and result.step == 4
    assert all(np.isfinite(v) for line in first.history + result.history for v in line.values())
    assert len(result.val_history) == 1
    assert CheckpointManager(run).all_steps() == [2, 4]

    merged = evaluate_policy.main(["--train-dir", str(run), "--fake-env", "--device-render",
                                   "--n-envs", "3", "--cohorts", "2", "--num-sequences", "3",
                                   "--ep-len", "3", "--device", "cpu"])
    results = json.loads((run / "evaluation" / "results.json").read_text())
    assert 0.0 <= results["latest"]["avg_seq_len"] <= 5.0
    assert merged["latest"]["avg_seq_len"] == results["latest"]["avg_seq_len"]
    model, cfg, step = load_policy(run)
    assert step == 4 and cfg == json.loads((run / "config.json").read_text())
    saved = torch.load(run / "saved_models" / "4.pt", weights_only=True)["model"]
    assert all(torch.equal(saved[k], v) for k, v in model.state_dict().items())
    evaluate_policy.main(["--train-dir", str(run), "--checkpoint", "2", "--fake-env", "--n-envs", "2",
                          "--num-sequences", "2", "--ep-len", "2", "--device", "cpu",
                          "--log-dir", str(tmp_path / "ev2")])
    assert "2" in json.loads((tmp_path / "ev2" / "results.json").read_text())
