"""The trainer's callbacks, sinks and retention on the CPU, against the JAX package.

The long-horizon and per-task callbacks of both packages drive the same
scripted expert on their own fake envs and must report the same metrics;
``shard_for_process``, the rollout videos' frames, ``merge_pretrained_params``
and the plan sampler are held to JAX's; ``create_plots`` and the tensorboard
sink write their files. The trainer's order (a failing callback keeps the
checkpoint, callbacks skipped after a preemption signal, their keys logged
and monitored) and the three JAX faults of this slice (retention by monitor,
the rollout agent's statistics, a text-tower policy's goals) are shown
beside JAX's behaviour.
"""
from __future__ import annotations

import json
import os
import signal
import types

import numpy as np
import pytest
import torch

from _torch_port_dataset import write_calvin_dir, write_expert_dir
from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.core.checkpoint import CheckpointManager
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.train import callbacks as cb_mod
from hulc2_torch.train import trainer as trainer_mod
from hulc2_torch.train.callback_factory import build_callbacks

TINY = [
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.visual_goal.hidden_size=32",
    "model.language_goal.hidden_size=32", "model.action_decoder.hidden_size=32",
    "model.language_encoder.width=32", "model.language_encoder.heads=2",
]
TASKS = ["open_drawer", "move_slider_left", "turn_on_lightbulb", "push_pink_block_right",
         "lift_red_block_table"]


@pytest.fixture(autouse=True)
def _one_thread(tmp_path, monkeypatch):
    """torch on one thread, and the chain cache in the test's directory."""
    monkeypatch.setenv("HULC2_SEQUENCES_CACHE_DIR", str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def expert_dir(tmp_path_factory):
    """Validation windows where the oracle sees tasks done (visual goals)."""
    return write_expert_dir(tmp_path_factory.mktemp("expert_cb"))


@pytest.fixture(scope="module")
def calvin96(tmp_path_factory):
    """A training set at the flagship's 96 / 64 pixel frames."""
    return write_calvin_dir(tmp_path_factory.mktemp("calvin96_cb"), static_hw=96, gripper_hw=64)


# ---- callbacks against JAX's ------------------------------------------------ #
@pytest.mark.parametrize("n,count", [(10, 1), (10, 3), (34, 4), (3, 5)])
def test_shard_for_process_equals_jax(n, count):
    from hulc2_tpu.train.callbacks import shard_for_process as jax_shard

    items = list(range(n))
    shards = [cb_mod.shard_for_process(items, i, count) for i in range(count)]
    assert shards == [jax_shard(items, i, count) for i in range(count)]
    assert sorted(sum(shards, [])) == items


def _expert_factory(expert_cls):
    """A rollout function factory that solves each subtask with the scripted
    expert (a deterministic policy, the same in both packages)."""

    def rollout_fn(env, subtask):
        return expert_cls(env, rng=np.random.default_rng(0)).solve(subtask, max_steps=200)

    return lambda *a: rollout_fn


def _both_envs():
    from hulc2_torch.envs.fake_env import FakeCalvinEnv
    from hulc2_tpu.envs.fake_env import FakeCalvinEnv as JaxEnv

    return (lambda: FakeCalvinEnv(render_obs=False)), (lambda: JaxEnv(render_obs=False))


def test_long_horizon_and_task_callbacks_equal_jax():
    """The same chains, tasks and scripted rollouts through both packages'
    callbacks give the same metrics, exactly; some succeed, some fail."""
    from hulc2_torch.envs.scripted_expert import ScriptedExpert
    from hulc2_tpu.envs.scripted_expert import ScriptedExpert as JaxExpert
    from hulc2_tpu.train import callbacks as jax_cb

    env, jax_env = _both_envs()
    got, want = {}, {}
    cb_mod.RolloutLongHorizonCallback(env, _expert_factory(ScriptedExpert), num_sequences=6)(
        None, epoch=1, val_metrics=got)
    jax_cb.RolloutLongHorizonCallback(jax_env, _expert_factory(JaxExpert), num_sequences=6)(
        None, epoch=1, state=None, val_metrics=want)
    for port_cls, jax_cls, env_pair in ((cb_mod.RolloutCallback, jax_cb.RolloutCallback,
                                         (env, jax_env)),):
        port_cls(env_pair[0], _expert_factory(ScriptedExpert), tasks=TASKS, rollouts_per_task=2,
                 every_n_epochs=1)(None, epoch=1, val_metrics=got)
        jax_cls(env_pair[1], _expert_factory(JaxExpert), tasks=TASKS, rollouts_per_task=2,
                every_n_epochs=1)(None, epoch=1, state=None, val_metrics=want)
    assert got == want
    assert 0.0 < got["eval_lh/avg_seq_len"] and 0.0 < got["tasks/average_sr"]
    assert set(got) == {f"eval_lh/sr_chain_{i}" for i in range(1, 6)} | {
        "eval_lh/avg_seq_len", "tasks/average_sr"} | {f"tasks/{t}_sr" for t in TASKS}
    # not due: nothing added
    skipped = {}
    cb_mod.RolloutCallback(env, None, every_n_epochs=2)(None, epoch=2, val_metrics=skipped)
    cb_mod.RolloutLongHorizonCallback(env, None, start_epoch=3)(None, epoch=2,
                                                                val_metrics=skipped)
    assert skipped == {}


def test_video_frames_equal_jax_byte_for_byte(tmp_path):
    """Border, caption and goal thumbnail on the same frames: the finished
    videos of both packages' ``RolloutVideo`` are equal; the port's writes
    one file per video."""
    from hulc2_torch.train.rollout_video import RolloutVideo
    from hulc2_tpu.train.rollout_video import RolloutVideo as JaxVideo

    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (5, 96, 96, 3), np.uint8)
    goal = rng.integers(0, 256, (96, 96, 3), np.uint8)
    videos = []
    for cls in (RolloutVideo, JaxVideo):
        v = cls(tmp_path / cls.__module__, tag_prefix="t")
        for ok, text in ((True, "open the drawer"), (False, "lift the red block")):
            v.new_video()
            for f in frames:
                v.update(f)
            v.add_goal_thumbnail(goal)
            v.draw_outcome(ok)
            v.add_language_instruction(text)
            v.finish_video(text.replace(" ", "_"))
        videos.append(v)
    got, want = videos[0]._videos, videos[1]._videos
    assert set(got) == set(want) and len(got) == 2
    for tag in want:
        assert got[tag].dtype == np.uint8 and np.array_equal(got[tag], want[tag]), tag
    assert not np.array_equal(got["open_the_drawer"][0], frames[0])
    paths = videos[0].write(step=3)
    assert len(paths) == 2 and all(p.is_file() and p.stat().st_size > 0 for p in paths)
    assert all(p.name.startswith("t_") and "_step3." in p.name for p in paths)


def test_merge_pretrained_params_equals_jax():
    """Equal shapes copied, a longer position embedding cut, a mismatched and
    a missing entry kept from init: the same leaves as JAX's on the same tree."""
    from hulc2_torch.utils.pretrain import get_portion_of_batch_ids, merge_pretrained_params
    from hulc2_tpu.utils import pretrain as jax_pretrain

    rng = np.random.default_rng(0)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    init = {"enc": {"kernel": arr(4, 3), "bias": arr(3)},
            "plan": {"position_embeddings": arr(8, 5), "w": arr(2, 2)},
            "head": {"kernel": arr(3, 3)}}
    pre = {"enc": {"kernel": arr(4, 3), "bias": arr(3)},
           "plan": {"position_embeddings": arr(16, 5), "w": arr(3, 2)}}
    want = jax_pretrain.merge_pretrained_params(init, pre)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict) else
                       {f"{prefix}{k}": torch.from_numpy(np.asarray(v))})
        return out

    got = merge_pretrained_params(flat(init), flat(pre))
    want_flat = flat(want)
    assert set(got) == set(want_flat)
    for k, w in want_flat.items():
        assert torch.equal(got[k], w), k
    assert torch.equal(got["plan.position_embeddings"], torch.from_numpy(pre["plan"]["position_embeddings"][:8]))
    assert torch.equal(got["plan.w"], torch.from_numpy(init["plan"]["w"]))
    for pct, n in ((0.5, 8), (0.3, 10), (0.0, 4), (1.0, 3)):
        np.testing.assert_array_equal(get_portion_of_batch_ids(pct, n),
                                      jax_pretrain.get_portion_of_batch_ids(pct, n))


def test_plan_sampler_equals_jax(monkeypatch):
    """Plans and modality ids of one val batch through ``make_plan_sampler``,
    JAX's with the same Gumbel draws, within rel 1e-5."""
    import jax
    import jax.numpy as jnp

    from _torch_port_common import build_both, make_raw_batch, small_config, torch_raw
    from hulc2_torch.data.device_transforms import make_batch_transform
    from hulc2_torch.train.steps import make_plan_sampler
    from hulc2_tpu.data import device_transforms as jdt
    from hulc2_tpu.data.statistics import DatasetStatistics
    from hulc2_tpu.models.distributions import PlanDistribution
    from hulc2_tpu.train.steps import make_plan_sampler as jax_plan_sampler

    cfg = small_config()
    jmodel, params, tmodel = build_both(cfg)
    raw = make_raw_batch(np.random.default_rng(4), cfg)
    d = cfg["model"]["distribution"]
    rng = np.random.default_rng(5)
    noise = {m: rng.gumbel(size=(2, d["category_size"], d["class_size"])).astype(np.float32)
             for m in ("lang", "vis")}
    queue = [noise["lang"], noise["vis"]]  # JAX samples in sorted modality order

    def sample(self, key, state):
        logits = self._logits(state)
        idx = jnp.argmax(logits + queue.pop(0), axis=-1)
        return jax.nn.one_hot(idx, self.class_size, dtype=logits.dtype).reshape(
            *logits.shape[:-2], -1)

    monkeypatch.setattr(PlanDistribution, "sample", sample)
    dm = cfg["datamodule"]
    jtf = jdt.make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                   DatasetStatistics(), dm["transforms"], train=False)
    jplans, jlabels = jax_plan_sampler(jmodel, {"vis": jtf, "lang": jtf})(
        params, jax.tree_util.tree_map(jnp.asarray, raw), jax.random.PRNGKey(0))
    ttf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                               dm["transforms"], dtype=torch.float32, train=False)
    plans, labels = make_plan_sampler(tmodel, ttf)(
        torch_raw(raw), None, {m: torch.from_numpy(v) for m, v in noise.items()})
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_allclose(plans.numpy(), np.asarray(jplans), rtol=1e-5, atol=1e-6)
    assert plans.shape == (4, d["category_size"] * d["class_size"])


def test_create_plots_writes_three_figures(tmp_path):
    from hulc2_torch.evaluation import create_plots, harness
    from hulc2_torch.evaluation.sequences import get_sequences

    seqs = get_sequences(4)
    harness.print_and_save({"10": [0, 2, 5, 1], "20": [3, 1, 0, 4]}, tmp_path / "a",
                           sequences=seqs)
    harness.print_and_save({"10": [1, 1, 1, 1]}, tmp_path / "b", sequences=seqs)
    out = tmp_path / "plots"
    paths = create_plots.main([str(tmp_path / "a" / "results.json"),
                               str(tmp_path / "b" / "results.json"), "--out-dir", str(out)])
    assert [p.name for p in paths] == ["chain_sr.png", "avg_seq_len.png", "task_sr.png"]
    for p in paths:
        assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and p.stat().st_size > 1000


def test_metrics_logger_sinks(tmp_path, caplog):
    """``logger=tb`` writes tensorboard events with the logged scalars;
    ``wandb``, absent here, falls back to metrics.jsonl with a warning; a
    process other than the main one writes nothing."""
    from hulc2_torch.core.metrics import MetricsLogger, print_system_env_info, timeit

    mlog = MetricsLogger(tmp_path / "run", use_tb=True, use_wandb=True)
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    assert mlog._tb is not None and mlog._wandb is None  # no wandb here
    for step in (1, 2):
        mlog.log({"loss": 1.0 / step}, step, prefix="train/")
    mlog.close()
    acc = EventAccumulator(str(tmp_path / "run" / "tb"))
    acc.Reload()
    assert [e.value for e in acc.Scalars("train/loss")] == [1.0, 0.5]
    assert len((tmp_path / "run" / "metrics.jsonl").read_text().splitlines()) == 2
    silent = MetricsLogger(tmp_path / "other", use_tb=True, is_main=False)
    assert silent.log({"x": 1}, 3)["x"] == 1.0 and not (tmp_path / "other").exists()
    info = print_system_env_info("cpu")
    assert info["rank"] == "0" and info["world_size"] == "1" and info["torch"] == torch.__version__
    sink = {}
    with timeit("t", sink):
        pass
    assert sink["t"] >= 0.0


# ---- the trainer's order, retention and the rollouts of a live policy ------ #
def _cfg(root, *extra) -> dict:
    return flagship_config(TINY + [
        f"datamodule.root_data_dir={root}", "datamodule.batch_size_vis=2",
        "datamodule.batch_size_lang=2", "datamodule.min_window_size=4",
        "datamodule.max_window_size=4", "datamodule.num_workers=1",
        "trainer.log_every_n_steps=1", "trainer.limit_train_batches=1",
        "trainer.limit_val_batches=1", *extra])


def _fit(cfg, run_dir, callbacks, max_epochs, make_step=None):
    dm = Hulc2DataModule(cfg["datamodule"], seed=cfg["seed"], device="cpu")
    dm.setup()
    trainer = trainer_mod.Trainer(cfg, dm, run_dir, device="cpu", callbacks=callbacks)
    if make_step is not None:
        trainer.make_train_step = make_step(trainer.make_train_step)
    return trainer.fit(max_epochs)


class ScoreCallback:
    """Adds ``eval_lh/avg_seq_len`` from a list, one per epoch."""

    def __init__(self, scores):
        self.scores = list(scores)
        self.epochs = []

    def __call__(self, trainer, epoch, val_metrics, **kw):
        self.epochs.append(epoch)
        val_metrics["eval_lh/avg_seq_len"] = self.scores[epoch]


def failing(trainer, epoch, val_metrics, **kw):
    val_metrics["tasks/partial"] = 1.0
    raise RuntimeError("rollout env crashed")


def test_failing_callback_keeps_checkpoint_and_best_k_are_kept(calvin96, tmp_path):
    """Three epochs under ``callbacks/checkpoint=lh_sr`` with top 2: a failing
    callback is logged, its partial key still logged, and every epoch's
    checkpoint written; the two best by ``eval_lh/avg_seq_len`` stay, not the
    newest two. JAX's trainer hands its manager no monitor
    (``hulc2_tpu/train/trainer.py:119``): that manager keeps the newest."""
    from hulc2_tpu.core.checkpoint import CheckpointManager as JaxManager

    scores = [0.5, 0.1, 0.2]
    score = ScoreCallback(scores)
    cfg = _cfg(calvin96, "callbacks/checkpoint=lh_sr", "callbacks.checkpoint.save_top_k=2")
    result = _fit(cfg, tmp_path / "run", [failing, score], max_epochs=3)
    assert score.epochs == [0, 1, 2] and len(result.callback_errors) == 3
    assert "rollout env crashed" in result.callback_errors[0]
    lines = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    cb_lines = [x for x in lines if "eval_lh/avg_seq_len" in x]
    assert [x["eval_lh/avg_seq_len"] for x in cb_lines] == scores
    assert all(x["tasks/partial"] == 1.0 for x in cb_lines)
    mgr = CheckpointManager(tmp_path / "run")
    assert mgr.all_steps() == [1, 3]  # epochs 0 and 2: scores 0.5 and 0.2
    assert mgr.restore(1)["metrics"]["eval_lh/avg_seq_len"] == 0.5
    assert "val/lang_act_loss_pp" in mgr.restore(3)["metrics"]
    jax_mgr = JaxManager(tmp_path / "jax_run", save_top_k=2)  # as trainer.py:119 builds it
    state = {"w": np.zeros(2, np.float32)}
    for step, s in zip((1, 2, 3), scores):
        jax_mgr.save(step, state, {"eval_lh/avg_seq_len": s})
    jax_mgr.wait()
    assert jax_mgr.all_steps() == [2, 3]
    jax_mgr.close()


def test_monitor_that_names_no_metric_raises(calvin96, tmp_path):
    """``callbacks/checkpoint=val_action`` monitors ``val/action_loss_pp``,
    which no metric of either package is called: the first save raises and
    lists the metrics there are. JAX's ``m.get(monitor, 0.0)`` ranks every
    step alike."""
    cfg = _cfg(calvin96, "callbacks/checkpoint=val_action")
    with pytest.raises(ValueError, match=r"val/action_loss_pp.*val/lang_act_loss_pp"):
        _fit(cfg, tmp_path / "run", [], max_epochs=1)


def test_callbacks_skipped_after_preemption(calvin96, tmp_path):
    """SIGUSR1 during the first step: no validation, no callback, and the
    checkpoint of step 1 written."""
    score = ScoreCallback([0.0])

    def make_signalling(make):
        def build():
            step = make()

            def signalling(*a, **kw):
                out = step(*a, **kw)
                os.kill(os.getpid(), signal.SIGUSR1)
                return out

            return signalling

        return build

    cfg = _cfg(calvin96, "callbacks/checkpoint=lh_sr")
    result = _fit(cfg, tmp_path / "run", [score], max_epochs=2, make_step=make_signalling)
    assert score.epochs == [] and result.val_history == [] and result.callback_history == []
    assert CheckpointManager(tmp_path / "run").all_steps() == [1]


def test_rollouts_of_the_live_policy(calvin96, expert_dir, tmp_path):
    """The callbacks that ``build_callbacks`` makes from the config, on the
    fake env at the policy's camera sizes: the long-horizon chains with a
    video, both modalities' per-task rollouts (the visual goals from the
    validation split's oracle-detected windows), and the t-SNE figure of the
    recorded plans; their keys reach metrics.jsonl, the policy is back in
    train mode, and the rollouts' policy calls are counted."""
    cfg = _cfg(calvin96, "logger=tb",
               'callbacks.rollout_lh={"env":"fake","num_sequences":2,"ep_len":2,'
               '"every_n_epochs":1,"start_epoch":0,"video_dir":"auto","num_videos":1}',
               'callbacks.rollout={"env":"fake","rollouts_per_task":1,"ep_len":2,'
               f'"every_n_epochs":1,"start_epoch":0,"dataset_path":"{expert_dir}"}}',
               'callbacks.tsne_plot={"every_n_epochs":1}')
    run = tmp_path / "run"
    cbs = build_callbacks(cfg, run)
    assert [type(c).__name__ for c in cbs] == ["RolloutLongHorizonCallback", "RolloutCallback",
                                                "RolloutCallback", "TSNEPlotCallback"]
    result = _fit(cfg, run, cbs, max_epochs=1)
    assert result.callback_errors == []
    line = result.callback_history[0]
    assert 0.0 <= line["eval_lh/avg_seq_len"] <= 5.0
    assert "tasks/average_sr" in line and "tasks_vis/average_sr" in line
    # a task is attempted where some initial state makes it unambiguous
    attempted = [k for k in line if k.startswith("tasks/") and k != "tasks/average_sr"]
    assert 20 < len(attempted) <= 34
    vis_tasks = [k for k in line if k.startswith("tasks_vis/") and k != "tasks_vis/average_sr"]
    assert vis_tasks
    lh, ro, vis, tsne = cbs
    assert lh.videos and all(p.is_file() for p in lh.videos)
    assert tsne.figures and tsne.figures[0].is_file()
    assert any(p.name.startswith("events") for p in (run / "tb").iterdir())
    assert result.model.training
    chains = sum(1 for _ in lh._sequences)
    assert len(attempted) <= ro.rollout_fn_factory.counts["policy_steps"] <= 2 * len(attempted)
    assert vis.rollout_fn_factory.counts["goals"] == len(vis_tasks)
    assert lh.rollout_fn_factory.counts["policy_steps"] >= 2 * chains
    logged = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert any("tasks_vis/average_sr" in x for x in logged)


def test_rollout_agent_statistics_and_goals_repaired(calvin96, monkeypatch):
    """JAX's rollout agent is built without statistics
    (``hulc2_tpu/train/callback_factory.py:43``) and a text-tower policy gets
    a float sentence embedding as its goal (``:85``), which the tower's token
    embedding refuses; the port's agent gets the training split's statistics
    and the caption's token ids."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from hulc2_torch.agents import hulc2_agent
    from hulc2_torch.envs.fake_env import FakeCalvinEnv
    from hulc2_torch.train.callback_factory import make_policy_rollout_fn_factory
    from hulc2_tpu.agents import hulc2_agent as jax_agent_mod
    from hulc2_tpu.train.callback_factory import make_policy_rollout_fn_factory as jax_factory

    seen = {}

    class Recorder:
        def __init__(self, *args, **kw):
            seen.setdefault("init", []).append(kw)
            self.env = kw.get("env", args[0] if args else None)

        def reset(self):
            pass

        def step(self, obs, goal):
            seen.setdefault("goals", []).append(goal)
            raise StopIteration

    monkeypatch.setenv("HULC2_ALLOW_STUB_EMBEDDINGS", "1")
    monkeypatch.setattr(jax_agent_mod, "Hulc2Agent", Recorder)
    monkeypatch.setattr(hulc2_agent, "Hulc2Agent", Recorder)
    cfg = _cfg(calvin96)
    dm = Hulc2DataModule(cfg["datamodule"], seed=0, device="cpu")
    dm.setup(splits=("training",))

    class T:
        model = torch.nn.Linear(1, 1)

    T.dm = dm
    env = FakeCalvinEnv(render_obs=False)
    state = types.SimpleNamespace(params=None)
    for factory, args in ((jax_factory(cfg, 2, None, env_spec="fake"), (T, state)),
                          (make_policy_rollout_fn_factory(cfg, 2, None, env_spec="fake"), (T,))):
        with pytest.raises(StopIteration):
            factory(*args)(env, "open_drawer")
    jax_kw, port_kw = seen["init"]
    jax_goal, port_goal = seen["goals"]
    assert jax_kw.get("stats") is None and port_kw["stats"] is dm.stats["training"]
    assert jax_goal["lang"].dtype == np.float32 and jax_goal["lang"].shape == (384,)
    assert port_goal["lang"].dtype.kind == "i" and port_goal["lang"].shape == (77,)
    with pytest.raises(ValueError, match="integer"):
        embed = nn.Embed(10, 4)
        embed.init(jax.random.PRNGKey(0), jnp.asarray(jax_goal["lang"])[None])


# ---- the device defaults and the import isolation --------------------------- #
def test_render_and_affordance_loaders_default_to_the_card(tmp_path):
    """``make_render_obs_fn`` and ``load_affordance`` resolve a missing device
    to the card, as every entry point of the package does: without a card
    the default raises ``resolve_device``'s error, and ``device="cpu"``
    works as before."""
    from hulc2_torch.affordance.train_affordance import build_detector
    from hulc2_torch.configs.affordance import affordance_config
    from hulc2_torch.core.checkpoint import save_run_config
    from hulc2_torch.envs.render_torch import make_render_obs_fn
    from hulc2_torch.evaluation.loading import load_affordance

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_render_obs_fn(96, 64)
    frames = make_render_obs_fn(96, 64, device="cpu")(torch.zeros((1, 24)), torch.zeros((1, 15)))
    assert frames["rgb_static"].shape == (1, 96, 96, 3)
    cfg = affordance_config(["aff_detection.decoder_channels=[32,16,8,8,8]",
                             "aff_detection.dataset.img_resize.static=64"])
    save_run_config(tmp_path, {**cfg, "depth_norm": {"mean": 0.5, "std": 2.0}})
    CheckpointManager(tmp_path).save(7, build_detector(cfg["aff_detection"]), None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_affordance(tmp_path)
    pred = load_affordance(tmp_path, device="cpu")
    assert next(pred.model.parameters()).device.type == "cpu"


def test_slice_modules_import_without_jax():
    """The modules of the callbacks, sinks and data-parallel slice import
    neither jax nor anything of the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    mods = ["hulc2_torch.core.metrics", "hulc2_torch.core.checkpoint",
            "hulc2_torch.utils.pretrain", "hulc2_torch.train.rollout_video",
            "hulc2_torch.train.callbacks", "hulc2_torch.train.callback_factory",
            "hulc2_torch.train.trainer", "hulc2_torch.train.steps", "hulc2_torch.training",
            "hulc2_torch.parallel.mesh", "hulc2_torch.parallel.batch_shard",
            "hulc2_torch.evaluation.create_plots"]
    code = (f"import sys; sys.path.insert(0, {str(repo)!r}); import " + ", ".join(mods)
            + "; bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'flax', 'optax', 'orbax', 'hulc2_tpu')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
