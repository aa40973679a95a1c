"""Evaluating a policy without a text tower (``cfg_low_level``'s embedding-table
goals) against the JAX package, on the CPU.

The ``--dataset-path`` goal table, the evaluator's records and the goal rows
handed to every agent call under the scripted-agent stubs
(``test_torch_port_eval_host.ScriptedAgent``) with float goals,
``policy_step`` and the agent on embedding goals, and the CLI: the goals it
hands the evaluator, and what it refuses for such a policy.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hulc2_tpu.envs.calvin_wrapper as jax_wrapper
import hulc2_tpu.envs.fake_env as jax_fake_env
import hulc2_tpu.evaluation.batched_eval as jax_batched
from hulc2_torch.core import config as cfg_lib
from hulc2_torch.envs import calvin_wrapper, fake_env
from hulc2_torch.evaluation import batched_eval, evaluate_policy, sequences, tasks
from test_torch_port_default_config import LOW_SMALL, SIZES, build_low_both
from test_torch_port_eval_host import ScriptedAgent
from test_torch_port_host_loader import EMB_DIM, write_low_level_dir
from test_torch_port_rollout import (_jax_policy_step_fn, install_policy_samplers, make_draws,
                                     robot_states, torch_draws)

LOW_TINY_MODEL = [
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.visual_goal.hidden_size=32",
    "model.language_goal.hidden_size=32", "model.action_decoder.hidden_size=32",
]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_low_level_dir(tmp_path_factory.mktemp("emb_eval"), 16, 16)


def _jax_table(root):
    from hulc2_tpu.evaluation.evaluate_policy import load_lang_embeddings as jax_load

    ann_emb, task_to_ann = jax_load(root, "lang_annotations")
    return {t: np.asarray(ann_emb[a], np.float32) for t, a in task_to_ann.items()}


def test_goal_table_equals_jax(data_dir):
    """Task -> the fp32 embedding of its canonical sentence, from
    ``validation/lang_annotations/embeddings.npy``, as the JAX CLI builds it;
    the file parser returns the same two tables."""
    from hulc2_tpu.evaluation.evaluate_policy import load_lang_embeddings_file as jax_file

    got, want = evaluate_policy.embedding_goals(data_dir, "lang_annotations"), _jax_table(data_dir)
    assert set(got) == set(want) == set(tasks.TASK_NAMES)
    for t, w in want.items():
        assert got[t].dtype == w.dtype == np.float32 and got[t].shape == (EMB_DIM,)
        np.testing.assert_array_equal(got[t], w)
    f = data_dir / "validation" / "lang_annotations" / "embeddings.npy"
    (ours, our_keys), (theirs, their_keys) = evaluate_policy.load_lang_embeddings_file(f), jax_file(f)
    assert our_keys == their_keys and ours.keys() == theirs.keys()
    assert all(np.array_equal(ours[k], theirs[k]) for k in theirs)


def _run(module, fake_env_module, farm_module, lang):
    goal_tasks = {np.asarray(v, np.float32).tobytes(): t for t, v in lang.items()}
    cohorts = []
    for c, size in enumerate((3, 2)):
        farm = farm_module.EnvFarm([fake_env_module.FakeCalvinEnv(static_hw=96, gripper_hw=64,
                                                                  render_obs=False)
                                    for _ in range(size)])
        agent = ScriptedAgent(size, goal_tasks, seed=c)
        agent.goals = []
        step = agent.step_async

        def recording(obs, goal, agent=agent, step=step):
            agent.goals.append(np.array(goal["lang"]))
            return step(obs, goal)

        agent.step_async = recording
        cohorts.append((farm, agent))
    ev = module.PipelinedEvaluator(cohorts, lang, ep_len=20)
    results = ev.evaluate(sequences=sequences.get_sequences(8), progress=False)
    return ev, results, [a for _, a in cohorts]


def test_evaluator_with_embedding_goals_equals_jax(data_dir):
    """Both evaluators with the dataset's table and the same scripted agents:
    results, records, and every goal row (fp32 embeddings) equal."""
    lang = evaluate_policy.embedding_goals(data_dir, "lang_annotations")
    ours, r_ours, agents = _run(batched_eval, fake_env, calvin_wrapper, lang)
    theirs, r_theirs, jagents = _run(jax_batched, jax_fake_env, jax_wrapper, _jax_table(data_dir))
    assert r_ours == r_theirs and len(r_ours) == 8
    assert ours.subtask_records == theirs.subtask_records
    assert ours.goal_dtype == np.float32 and ours.goal_dim == EMB_DIM
    for a, b in zip(agents, jagents):
        assert len(a.goals) == len(b.goals) > 0
        for x, y in zip(a.goals, b.goals):
            assert x.dtype == y.dtype == np.float32 and x.shape == (a.n_envs, EMB_DIM)
            np.testing.assert_array_equal(x, y)


def test_policy_step_with_embedding_goals_matches_jax(monkeypatch):
    """12 steps of 3 envs of the policy without a tower, goals the envs'
    embeddings, same weights and draws: actions and hidden state atol 1e-4,
    plans exact. Then the agent takes the same goals as host arrays."""
    from hulc2_torch.agents.hulc2_agent import Hulc2Agent

    holder = install_policy_samplers(monkeypatch)
    cfg = cfg_lib.compose("cfg_low_level", LOW_SMALL)
    jmodel, params, tmodel = build_low_both(cfg, seed=3)
    tmodel.eval()
    jstep = _jax_policy_step_fn(jmodel, holder)
    b = 3
    rng = np.random.default_rng(4)
    lang = rng.standard_normal((b, EMB_DIM)).astype(np.float32)
    jcarry, tcarry = jmodel.init_carry(b), tmodel.init_carry(b, "cpu")
    for t in range(12):
        rgb = {cam: (rng.integers(0, 256, (b, 1, hw, hw, 3)) / 127.5 - 1.0).astype(np.float32)
               for cam, hw in SIZES.items()}
        robot = robot_states(rng, b)[:, None]
        draws = make_draws(rng, cfg, b)
        want, jcarry = jstep(params, {k: jnp.asarray(v) for k, v in rgb.items()}, jnp.asarray(robot),
                             jnp.asarray(lang), jcarry, *(jnp.asarray(draws[k]) for k in ("g", "u_sel", "u")))
        with torch.inference_mode():
            got, tcarry = tmodel.policy_step({k: torch.from_numpy(v) for k, v in rgb.items()},
                                             torch.from_numpy(robot), {"lang": torch.from_numpy(lang)},
                                             tcarry, draws=torch_draws(draws))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=f"step {t}")
        np.testing.assert_array_equal(tcarry.plan.numpy(), np.asarray(jcarry.plan))
        np.testing.assert_allclose(tcarry.hidden.numpy(), np.asarray(jcarry.hidden), atol=1e-4)
    farm = calvin_wrapper.EnvFarm([fake_env.FakeCalvinEnv(static_hw=200, gripper_hw=84)
                                   for _ in range(2)])
    agent = Hulc2Agent(tmodel, cfg["datamodule"], n_envs=2)
    act = agent.step(farm.reset(), {"lang": lang[0]})
    assert act.shape == (2, 7) and np.abs(act).max() <= 1.0


def _embedding_run(root, step=1):
    from hulc2_torch.core.checkpoint import CheckpointManager, save_run_config
    from hulc2_torch.models.build import build_policy

    cfg = cfg_lib.compose("cfg_low_level", LOW_TINY_MODEL)
    save_run_config(root, cfg)
    CheckpointManager(root).save(step, build_policy(cfg["model"], gripper_hw=84, seed=step), None)
    return root


def _spy(monkeypatch):
    made = []

    class Spy(batched_eval.PipelinedEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(batched_eval, "PipelinedEvaluator", Spy)
    return made


def test_cli_evaluates_an_embedding_policy(tmp_path, monkeypatch, data_dir):
    """``--train-dir`` of a ``cfg_low_level`` run with ``--dataset-path``:
    the evaluator's goals are the JAX table, frames render at 200/84 on the
    device path, results and diagnostics are written."""
    monkeypatch.setenv("HULC2_SEQUENCES_CACHE_DIR", str(tmp_path))
    made = _spy(monkeypatch)
    run = _embedding_run(tmp_path / "run")
    merged = evaluate_policy.main(["--train-dir", str(run), "--fake-env", "--device-render",
                                   "--dataset-path", str(data_dir), "--n-envs", "3", "--cohorts", "2",
                                   "--num-sequences", "3", "--ep-len", "3", "--device", "cpu"])
    (ev,) = made
    want = _jax_table(data_dir)
    assert set(ev.lang) == set(want) and all(np.array_equal(ev.lang[t], want[t]) for t in want)
    assert ev.lang_variants is None and ev.affordance is None
    assert 0.0 <= merged["latest"]["avg_seq_len"] <= 5.0
    diag = json.loads((run / "evaluation" / "eval_diagnostics.json").read_text())
    assert diag["dispatches"] > 0 and len({r["chain"] for r in diag["subtask_records"]}) == 3


def test_cli_refuses_for_an_embedding_policy(tmp_path, data_dir, capsys):
    """Without ``--dataset-path``, with ``--paraphrase-eval`` and with
    ``--aff-lang-embeddings`` but no detector, each by name; a token
    policy's ``--dataset-path`` stays refused outside ``--single-step``."""
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.core.checkpoint import CheckpointManager, save_run_config
    from hulc2_torch.models.build import build_policy

    run = _embedding_run(tmp_path / "run")
    token_run = tmp_path / "token"
    save_run_config(token_run, flagship_config(LOW_TINY_MODEL))
    CheckpointManager(token_run).save(1, build_policy(flagship_config(LOW_TINY_MODEL)["model"]), None)
    data = ["--dataset-path", str(data_dir)]
    for argv, msg in (([], "takes its goals from --dataset-path"),
                      (data + ["--paraphrase-eval"], "needs a policy with the in-graph text tower"),
                      (data + ["--aff-lang-embeddings", str(tmp_path / "emb.npy")],
                       "need --aff-train-dir")):
        with pytest.raises(SystemExit):
            evaluate_policy.main(["--train-dir", str(run), "--fake-env", "--device", "cpu", *argv])
        assert msg in capsys.readouterr().err
    with pytest.raises(SystemExit):
        evaluate_policy.main(["--train-dir", str(token_run), "--fake-env", "--device", "cpu", *data])
    assert "this policy tokenizes its goals" in capsys.readouterr().err
