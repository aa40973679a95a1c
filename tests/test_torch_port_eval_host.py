"""The port's host-side copies of the evaluation protocol against the JAX package's.

The chain generator, initial states, task oracle, fake env, env farm,
tokenizer, validation sentences and results aggregation must equal the
originals exactly on seeded inputs; the port's evaluator and the JAX one,
driven by the same scripted agent, must produce identical results and
per-subtask records. Also: the two evaluator faults repaired in the port's
copy, the CLI on the CPU, and the host copies' freedom from torch at import
(the chain generator's pool workers import them).
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import hulc2_tpu.envs.calvin_wrapper as jax_wrapper
import hulc2_tpu.envs.fake_env as jax_fake_env
import hulc2_tpu.envs.task_oracle as jax_oracle
import hulc2_tpu.evaluation.batched_eval as jax_batched
import hulc2_tpu.evaluation.harness as jax_harness
import hulc2_tpu.evaluation.initial_states as jax_initial
import hulc2_tpu.evaluation.sequences as jax_sequences
import hulc2_tpu.evaluation.tasks as jax_tasks
from hulc2_torch.envs import calvin_wrapper, fake_env, scene_layout, task_oracle
from hulc2_torch.evaluation import batched_eval, harness, initial_states, sequences, tasks
from hulc2_torch.ops import fnv

REPO = Path(__file__).resolve().parents[1]
GOLDEN = json.loads((Path(__file__).parent / "golden_chains.json").read_text())
TINY = [
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.visual_goal.hidden_size=32",
    "model.language_goal.hidden_size=32", "model.action_decoder.hidden_size=32",
    "model.language_encoder.width=32", "model.language_encoder.heads=2",
]


class TestProtocolCopies:
    def test_task_model_equals_jax(self):
        assert tasks.TASK_NAMES == jax_tasks.TASK_NAMES and tasks.COLORS == jax_tasks.COLORS
        for state in sequences.enumerate_initial_states()[::7]:
            for name in tasks.TASK_NAMES:
                assert tasks.successor_states(state, name) == jax_tasks.successor_states(state, name)

    def test_chains_equal_jax_and_golden(self):
        """Recomputed without the disk cache: 60 chains against the JAX
        generator, and the first chains of the 1000-chain benchmark against
        the fixture the JAX package verified against the reference."""
        ours, theirs = sequences._compute_sequences(60), jax_sequences._compute_sequences(60)
        assert [(dict(s), tuple(c)) for s, c in ours] == [(dict(s), tuple(c)) for s, c in theirs]
        full = sequences._compute_sequences(1000)
        assert len(full) == 1000
        for expected, (state, chain) in zip(GOLDEN, full):
            assert dict(state) == expected["state"] and list(chain) == expected["chain"]

    def test_sequence_disk_cache_roundtrips(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HULC2_SEQUENCES_CACHE_DIR", str(tmp_path))
        first = sequences.get_sequences.__wrapped__(9)
        cached = list(tmp_path.glob("hulc2_torch_sequences_9_*.json"))
        assert len(cached) == 1
        assert sequences.get_sequences.__wrapped__(9) == first == jax_sequences._compute_sequences(9)

    def test_initial_states_equal_jax(self):
        for state in sequences.enumerate_initial_states():
            for ours, theirs in zip(initial_states.get_env_state_for_initial_condition(dict(state)),
                                    jax_initial.get_env_state_for_initial_condition(dict(state))):
                np.testing.assert_array_equal(ours, theirs)

    def test_fnv_equals_jax(self):
        from hulc2_tpu.ops import fnv as jax_fnv

        for i in range(0, 5000, 37):
            data = str(i).encode()
            assert fnv.fnv1_32(data) == jax_fnv.fnv1_32(data)
            assert fnv.get_validation_window_size(i, 20, 32) == jax_fnv.get_validation_window_size(i, 20, 32)

    def test_oracle_equals_jax_on_random_scene_pairs(self):
        rng = np.random.default_rng(0)
        ours, theirs = task_oracle.SceneObsTaskOracle(), jax_oracle.SceneObsTaskOracle()
        states = [initial_states.get_env_state_for_initial_condition(dict(s))[1]
                  for s in sequences.enumerate_initial_states()[:40]]
        for _ in range(300):
            a, b = (states[i] + rng.normal(0, 0.05, 24) * rng.integers(0, 2, 24)
                    for i in rng.integers(0, len(states), 2))
            start, end = {"scene_obs": a}, {"scene_obs": b}
            assert (ours.get_task_info_for_set(start, end, tasks.TASK_NAMES)
                    == theirs.get_task_info_for_set(start, end, jax_tasks.TASK_NAMES))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_fake_env_trajectories_equal_jax(self, seed):
        """50 steps under random actions from one evaluation initial state:
        the same states, infos and rendered frames."""
        rng = np.random.default_rng(seed)
        state, _ = sequences.get_sequences(8)[seed]
        robot, scene = initial_states.get_env_state_for_initial_condition(dict(state))
        envs = [fake_env.FakeCalvinEnv(static_hw=96, gripper_hw=64),
                jax_fake_env.FakeCalvinEnv(static_hw=96, gripper_hw=64, seed=seed)]
        obs = [e.reset(robot_obs=robot, scene_obs=scene) for e in envs]
        for t in range(50):
            action = rng.uniform(-1, 1, 7)
            action[2] -= 0.5  # reach down towards the table now and then
            steps = [e.step(action) for e in envs]
            obs = [s[0] for s in steps]
            for key in ("robot_obs", "scene_obs"):
                np.testing.assert_array_equal(obs[0][key], obs[1][key], err_msg=f"step {t}")
                np.testing.assert_array_equal(steps[0][3][key], steps[1][3][key])
            for cam in ("rgb_static", "rgb_gripper"):
                np.testing.assert_array_equal(obs[0]["rgb_obs"][cam], obs[1]["rgb_obs"][cam])
            np.testing.assert_array_equal(obs[0]["depth_obs"]["depth_static"],
                                          obs[1]["depth_obs"]["depth_static"])

    def test_state_only_obs_and_env_farm(self):
        envs = [fake_env.FakeCalvinEnv(static_hw=96, gripper_hw=64, render_obs=False)
                for _ in range(3)]
        stacked = calvin_wrapper.EnvFarm(envs).reset()
        assert stacked["rgb_obs"] == {} and stacked["robot_obs"].shape == (3, 15)
        envs = [fake_env.FakeCalvinEnv(static_hw=96, gripper_hw=64) for _ in range(2)]
        jenvs = [jax_fake_env.FakeCalvinEnv(static_hw=96, gripper_hw=64, seed=i) for i in range(2)]
        ours, theirs = calvin_wrapper.EnvFarm(envs).reset(), jax_wrapper.EnvFarm(jenvs).reset()
        for group in ("rgb_obs", "depth_obs"):
            for cam in theirs[group]:
                np.testing.assert_array_equal(ours[group][cam], theirs[group][cam])
        np.testing.assert_array_equal(ours["scene_obs"], theirs["scene_obs"])

    def test_scene_layout_equals_jax(self):
        from hulc2_tpu.envs import scene_layout as jax_layout

        names = [n for n in dir(jax_layout) if n.isupper()]
        assert names == [n for n in dir(scene_layout) if n.isupper()]
        for n in names:
            ours, theirs = getattr(scene_layout, n), getattr(jax_layout, n)
            if isinstance(theirs, dict):
                assert ours.keys() == theirs.keys(), n
                ours, theirs = list(ours.values()), list(theirs.values())
            np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs), err_msg=n)

    def test_tokenizer_and_validation_bank_equal_jax(self):
        from hulc2_tpu.tools.annotations import VALIDATION_BANK as jax_bank
        from hulc2_tpu.utils.clip_tokenizer import tokenize as jax_tokenize
        from hulc2_torch.tools.annotations import VALIDATION_BANK
        from hulc2_torch.utils.clip_tokenizer import ASSET_PATH, tokenize

        assert VALIDATION_BANK == jax_bank
        assert ASSET_PATH.parent == REPO / "hulc2_torch" / "assets"
        sentences = [VALIDATION_BANK[t] for t in tasks.TASK_NAMES]
        np.testing.assert_array_equal(tokenize(sentences), jax_tokenize(sentences))

    def test_results_aggregation_equals_jax(self, tmp_path):
        seqs = sequences.get_sequences(12)
        results = list(np.random.default_rng(3).integers(0, 6, len(seqs)))
        assert harness.count_success(results) == jax_harness.count_success(results)
        assert harness.summarize(results, seqs) == jax_harness.summarize(results, seqs)
        ours = harness.print_and_save({"a": results}, tmp_path / "ours", sequences=seqs)
        theirs = jax_harness.print_and_save({"a": results}, tmp_path / "jax", sequences=seqs)
        assert ours == theirs
        assert ((tmp_path / "ours" / "results.json").read_text()
                == (tmp_path / "jax" / "results.json").read_text())


class ScriptedAgent:
    """A framework-free agent: host-array actions from its own seeded stream,
    steered towards the LED button when the goal is an LED task, so that
    some subtasks succeed."""

    def __init__(self, n_envs: int, goal_tasks: dict, seed: int):
        self.n_envs = n_envs
        self.goal_tasks = goal_tasks
        self.rng = np.random.default_rng(seed)
        self.resets = []
        self.calls = 0

    def reset_env_slot(self, i: int) -> None:
        self.resets.append(i)

    def step_async(self, obs, goal):
        self.calls += 1
        acts = self.rng.uniform(-1, 1, (self.n_envs, 7))
        for i in range(self.n_envs):
            if "led" in self.goal_tasks[np.asarray(goal["lang"][i]).tobytes()]:
                d = scene_layout.BUTTON_POS - obs["robot_obs"][i][:3]
                acts[i, :3] = np.clip(d / scene_layout.POS_STEP, -1, 1)
                acts[i, 3:6] = 0.0
        return acts


def _run_evaluator(module, fake_env_module, farm_module, n_chains, ep_len, **kwargs):
    lang = {t: np.arange(4, dtype=np.int32) + 10 * i for i, t in enumerate(tasks.TASK_NAMES)}
    goal_tasks = {v.tobytes(): t for t, v in lang.items()}
    cohorts = []
    for c, size in enumerate((3, 2)):
        farm = farm_module.EnvFarm([fake_env_module.FakeCalvinEnv(static_hw=96, gripper_hw=64,
                                                                  render_obs=False)
                                    for _ in range(size)])
        cohorts.append((farm, ScriptedAgent(size, goal_tasks, seed=c)))
    ev = module.PipelinedEvaluator(cohorts, lang, ep_len=ep_len, **kwargs)
    results = ev.evaluate(sequences=sequences.get_sequences(n_chains), progress=False)
    return ev, results, [agent for _, agent in cohorts]


class TestEvaluator:
    def test_port_evaluator_equals_jax_evaluator(self):
        ours, r_ours, agents_ours = _run_evaluator(batched_eval, fake_env, calvin_wrapper, 12, 25)
        theirs, r_theirs, agents_theirs = _run_evaluator(jax_batched, jax_fake_env, jax_wrapper, 12, 25)
        assert r_ours == r_theirs and len(r_ours) == 12
        assert ours.subtask_records == theirs.subtask_records
        assert [a.resets for a in agents_ours] == [a.resets for a in agents_theirs]
        assert any(r["success"] for r in ours.subtask_records)
        assert ours.total_env_steps == theirs.total_env_steps
        assert ours.n_dispatches == sum(a.calls for a in agents_ours) == sum(
            a.calls for a in agents_theirs)

    def test_evaluate_resets_finished_chains(self, tmp_path):
        """A second ``evaluate`` on the same evaluator counts only its own
        finished chains (the JAX copy keeps the first run's as well)."""
        ev, _, _ = _run_evaluator(batched_eval, fake_env, calvin_wrapper, 6, 5)
        ev.partial_path = tmp_path / "partial_results.json"
        ev.evaluate(sequences=sequences.get_sequences(4), progress=False)
        assert sorted(ev._done_idx) == [0, 1, 2, 3]
        ev._dump_partial(n_jobs=4, elapsed_s=1.0, n_steps=10)
        snap = json.loads(ev.partial_path.read_text())
        assert snap["completed_chains"] == 4 and snap["total_chains"] == 4

    def test_partial_dump_replaces_atomically(self, tmp_path, monkeypatch):
        ev = batched_eval.PipelinedEvaluator([], {"t": np.zeros(4, np.float32)})
        ev.partial_path = tmp_path / "partial_results.json"
        ev.partial_path.write_text("previous snapshot")
        ev._results, ev._done_idx = [3, 0, 5, 1, 0, 0], [2, 0, 3]
        replaced = []
        real_replace = batched_eval.os.replace

        def replace(src, dst):
            replaced.append((Path(src), Path(dst)))
            assert ev.partial_path.read_text() == "previous snapshot"  # untouched until the swap
            real_replace(src, dst)

        monkeypatch.setattr(batched_eval.os, "replace", replace)
        ev._dump_partial(n_jobs=6, elapsed_s=10.0, n_steps=4000)
        assert len(replaced) == 1 and replaced[0][1] == ev.partial_path
        assert replaced[0][0] != ev.partial_path and not replaced[0][0].exists()
        d = json.loads(ev.partial_path.read_text())
        assert d["completed_chains"] == 3 and d["avg_seq_len_partial"] == 3.0
        assert d["chain_sr_partial"][0] == 1.0 and d["env_steps_per_s"] == 400.0
        assert list(tmp_path.iterdir()) == [ev.partial_path]

    def test_async_fetch_passes_host_arrays(self):
        import torch

        a = np.arange(14, dtype=np.float32).reshape(2, 7)
        assert batched_eval._AsyncFetch(a).get() is a
        np.testing.assert_array_equal(batched_eval._AsyncFetch(torch.from_numpy(a)).get(), a)


class TestCli:
    def test_cli_runs_on_cpu_when_asked(self, tmp_path):
        from hulc2_torch import kernels
        from hulc2_torch.evaluation import evaluate_policy

        before = dict(kernels.LAUNCHES)
        merged = evaluate_policy.main([
            "--synthetic", "--fake-env", "--device-render", "--n-envs", "3", "--cohorts", "2",
            "--num-sequences", "4", "--ep-len", "3", "--log-dir", str(tmp_path), "--device", "cpu",
            *TINY])
        assert kernels.LAUNCHES == before  # the CPU runs the plain versions
        results = json.loads((tmp_path / "results.json").read_text())
        assert results["synthetic"] == json.loads(json.dumps(merged["synthetic"]))
        assert 0.0 <= merged["synthetic"]["avg_seq_len"] <= 5.0
        diag = json.loads((tmp_path / "eval_diagnostics.json").read_text())
        assert diag["cohorts"] == 2 and diag["dispatches"] > 0
        assert len({r["chain"] for r in diag["subtask_records"]}) == 4

    def test_cli_host_render_runs_on_cpu(self, tmp_path):
        from hulc2_torch.evaluation import evaluate_policy

        merged = evaluate_policy.main([
            "--synthetic", "--fake-env", "--n-envs", "2", "--num-sequences", "2", "--ep-len", "2",
            "--log-dir", str(tmp_path), "--device", "cpu", *TINY])
        assert merged["synthetic"]["avg_seq_len"] >= 0.0

    def test_cli_refuses(self, tmp_path):
        import torch
        from hulc2_torch.evaluation import evaluate_policy

        for argv in (["--train-dir", "x", "--fake-env"], ["--synthetic"], ["--fake-env"]):
            with pytest.raises(SystemExit):
                evaluate_policy.main(argv + ["--log-dir", str(tmp_path)])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                evaluate_policy.main(["--synthetic", "--fake-env", "--log-dir", str(tmp_path), *TINY])


def test_host_copies_import_without_torch():
    mods = ["hulc2_torch.evaluation.sequences", "hulc2_torch.evaluation.batched_eval",
            "hulc2_torch.evaluation.harness", "hulc2_torch.envs.fake_env",
            "hulc2_torch.envs.calvin_wrapper", "hulc2_torch.envs.task_oracle",
            "hulc2_torch.utils.clip_tokenizer", "hulc2_torch.tools.annotations"]
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import " + ", ".join(mods)
            + "; bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'));"
            " print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
