"""The port's other evaluation protocols against the JAX package, on the CPU.

The evaluator under paraphrase variants (results, records, and the goal and
affordance rows handed to every call, exactly), the single-step job lists,
the offline planner, results.json with the repaired "best", the
every-checkpoint sweep with the flags the JAX sweep drops or rejects, the
interactive entry point, and the annotator's lookback at short windows.
"""
import io
import json
import logging
from pathlib import Path

import numpy as np
import pytest

import hulc2_tpu.envs.calvin_wrapper as jax_wrapper
import hulc2_tpu.envs.fake_env as jax_fake_env
import hulc2_tpu.evaluation.batched_eval as jax_batched
import hulc2_tpu.evaluation.harness as jax_harness
from _torch_port_dataset import write_expert_dir
from hulc2_torch.envs import calvin_wrapper, fake_env
from hulc2_torch.evaluation import batched_eval, harness, llm_planning, sequences, tasks
from test_torch_port_eval_host import TINY, ScriptedAgent
from test_torch_port_hierarchical import StubPredictor

N_VARIANTS = 3
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def expert_dir(tmp_path_factory):
    return write_expert_dir(tmp_path_factory.mktemp("expert"))


def _tiny_run(root, steps=(1, 2), **overrides):
    """A run dir of the port holding the tiny-width flagship's config and one
    random checkpoint per step (weights seeded by the step)."""
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.core.checkpoint import CheckpointManager, save_run_config
    from hulc2_torch.models.build import build_policy

    cfg = flagship_config(TINY)
    save_run_config(root, {**cfg, **overrides})
    for s in steps:
        CheckpointManager(root).save(s, build_policy(cfg["model"], seed=s), None)
    return root


# ---- the evaluator under variants ------------------------------------ #
class RecordingAgent(ScriptedAgent):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.goals = []

    def step_async(self, obs, goal):
        self.goals.append(np.array(goal["lang"]))
        return super().step_async(obs, goal)


class RecordingPredictor(StubPredictor):
    """Records the language row of every query, batched (the port answers a
    flush with one batch) or single (JAX's flush of one query)."""

    def __init__(self):
        super().__init__()
        self.langs = []

    def predict(self, img, lang):
        self.langs.append(np.asarray(lang))
        return super().predict(img, lang)

    def predict_batch(self, imgs, langs):
        self.langs.extend(np.asarray(v) for v in langs)
        return super().predict_batch(imgs, langs)


def _variant_tables():
    lang = {t: np.arange(4, dtype=np.int32) + 100 * i for i, t in enumerate(tasks.TASK_NAMES)}
    variants = {t: [v + 10 * (j + 1) for j in range(N_VARIANTS)] for t, v in lang.items()}
    aff_variants = {t: [v + 1000 + j for j in range(N_VARIANTS)] for t, v in lang.items()}
    goal_tasks = {v.tobytes(): t for t, vs in variants.items() for v in vs}
    return lang, variants, aff_variants, goal_tasks


def _run_variants(module, fake_env_module, farm_module, hierarchical):
    lang, variants, aff_variants, goal_tasks = _variant_tables()
    cohorts = []
    for c, size in enumerate((3, 2)):
        farm = farm_module.EnvFarm([fake_env_module.FakeCalvinEnv(static_hw=96, gripper_hw=64,
                                                                  render_obs=False)
                                    for _ in range(size)])
        cohorts.append((farm, RecordingAgent(size, goal_tasks, seed=c)))
    pred = RecordingPredictor() if hierarchical else None
    ev = module.PipelinedEvaluator(cohorts, lang, ep_len=20, affordance=pred,
                                   aff_lang_embeddings=lang if hierarchical else None,
                                   lang_variants=variants,
                                   aff_lang_variants=aff_variants if hierarchical else None)
    results = ev.evaluate(sequences=sequences.get_sequences(10), progress=False)
    return ev, results, [a for _, a in cohorts], pred


@pytest.mark.parametrize("hierarchical", [False, True], ids=["flat", "hierarchical"])
def test_evaluator_under_variants_equals_jax(hierarchical):
    ours, r_ours, agents, pred = _run_variants(batched_eval, fake_env, calvin_wrapper, hierarchical)
    theirs, r_theirs, jagents, jpred = _run_variants(jax_batched, jax_fake_env, jax_wrapper,
                                                     hierarchical)
    assert r_ours == r_theirs and len(r_ours) == 10
    assert ours.subtask_records == theirs.subtask_records
    for a, b in zip(agents, jagents):
        assert len(a.goals) == len(b.goals) > 0
        for x, y in zip(a.goals, b.goals):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    # every chain's goals are its variant job_idx % n: the record of chain c
    # at position p names the task, and the goal rows carry the variant
    lang, variants, aff_variants, _ = _variant_tables()
    used = {(int(v[0]) // 100, int(v[0]) % 100 // 10) for a in agents for g in a.goals for v in g}
    assert {j for _, j in used} == set(range(1, N_VARIANTS + 1))
    if hierarchical:
        assert len(pred.langs) == len(jpred.langs) > 0
        for x, y in zip(pred.langs, jpred.langs):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        rows = np.stack(pred.langs)
        assert len(rows) == ours.n_aff_predictions == len(ours.subtask_records)
        # the detector's rows in record order: chain c's task at variant c % n
        want = [aff_variants[r["task"]][r["chain"] % N_VARIANTS] for r in
                sorted(ours.subtask_records, key=lambda r: (r["chain"], r["pos"]))]
        assert sorted(map(bytes, rows)) == sorted(map(bytes, want))
        assert ours.n_approaches == theirs.n_approaches > 0


def test_goal_rotation_equals_jax():
    """``goal_for``/``aff_goal_for`` for every task and job index, with and
    without variants, and the unbatched ``make_approach`` under variants."""
    lang, variants, aff_variants, _ = _variant_tables()
    for var, aff in ((variants, aff_variants), (None, None)):
        ours = batched_eval.PipelinedEvaluator([], lang, aff_lang_embeddings=lang,
                                               lang_variants=var, aff_lang_variants=aff)
        theirs = jax_batched.PipelinedEvaluator([], lang, aff_lang_embeddings=lang,
                                                lang_variants=var, aff_lang_variants=aff)
        for t in tasks.TASK_NAMES:
            for j in range(7):
                np.testing.assert_array_equal(ours.goal_for(t, j), theirs.goal_for(t, j))
                np.testing.assert_array_equal(ours.aff_goal_for(t, j), theirs.aff_goal_for(t, j))
                if var:
                    np.testing.assert_array_equal(ours.goal_for(t, j), var[t][j % N_VARIANTS])
    pred = RecordingPredictor()
    ev = batched_eval.PipelinedEvaluator([], lang, affordance=pred, aff_lang_embeddings=lang,
                                         aff_lang_variants=aff_variants)
    env = fake_env.FakeCalvinEnv(static_hw=96)
    ev.make_approach(env, env.reset(), "open_drawer", job_idx=5)
    np.testing.assert_array_equal(pred.langs[-1], aff_variants["open_drawer"][5 % N_VARIANTS])


def test_batched_evaluator_is_one_cohort():
    lang, _, _, goal_tasks = _variant_tables()
    goal_tasks.update({v.tobytes(): t for t, v in lang.items()})
    farm = calvin_wrapper.EnvFarm([fake_env.FakeCalvinEnv(static_hw=96, gripper_hw=64,
                                                          render_obs=False) for _ in range(2)])
    agent = ScriptedAgent(2, goal_tasks, seed=0)
    ev = batched_eval.BatchedEvaluator(farm, agent, lang, ep_len=5)
    assert (ev.farm, ev.agent, ev.k, len(ev.cohorts)) == (farm, agent, 2, 1)
    jfarm = jax_wrapper.EnvFarm([jax_fake_env.FakeCalvinEnv(static_hw=96, gripper_hw=64,
                                                           render_obs=False) for _ in range(2)])
    jev = jax_batched.BatchedEvaluator(jfarm, ScriptedAgent(2, goal_tasks, seed=0), lang, ep_len=5)
    seqs = sequences.get_sequences(4)
    assert ev.evaluate(sequences=seqs, progress=False) == jev.evaluate(sequences=seqs, progress=False)
    assert ev.subtask_records == jev.subtask_records


# ---- single-step job lists ------------------------------------------- #
def test_singlestep_sequences_equal_jax():
    seqs = sequences.get_sequences(25)
    ours, theirs = harness.singlestep_sequences(seqs), jax_harness.singlestep_sequences(seqs)
    assert ours == theirs and all(len(chain) == 1 for _, chain in ours)


def test_dataset_singlestep_sequences_equal_jax(expert_dir):
    val = expert_dir / "validation"
    ours = harness.dataset_singlestep_sequences(val)
    theirs = jax_harness.dataset_singlestep_sequences(val)
    assert len(ours) == len(theirs) == 5
    for (s, c), (js, jc) in zip(ours, theirs):
        assert tuple(c) == tuple(jc) and len(c) == 1
        assert s.keys() == js.keys()
        for k in s:
            assert s[k].dtype == js[k].dtype == np.float64
            assert np.array_equal(s[k], js[k])
    capped = harness.dataset_singlestep_sequences(val, max_per_task=1)
    assert capped == [] or len(capped) == len({c for _, c in ours})


# ---- the offline planner ---------------------------------------------- #
def test_planner_equals_jax():
    from hulc2_tpu.evaluation import llm_planning as jax_planning
    from hulc2_torch.tools.annotations import ANNOTATION_BANK

    assert llm_planning.FEW_SHOT_PROMPT == jax_planning.FEW_SHOT_PROMPT
    plans = ["\nopen_drawer()\nlift(red, table)\nplace_in(drawer)\nrotate(blue, left)\nnonsense()\n",
             "turn_off_lightbulb()\nclose_drawer()", "push('pink', right)\nlift(green, table)",
             "stack_block()\n  unstack_block()\npush_into_drawer()\nplace_in()"]
    for text in plans:
        assert llm_planning.parse_plan(text) == jax_planning.parse_plan(text)
    commands = ["please open the drawer and turn on the led", "open the drawer",
                "make the room bright", "tidy the red block into the drawer", "whatever"]
    commands += [a for phrases in ANNOTATION_BANK.values() for a in phrases]
    ours, theirs = llm_planning.LLMPlanner(), jax_planning.LLMPlanner()
    for cmd in commands:
        assert llm_planning.keyword_planner(cmd) == jax_planning.keyword_planner(cmd), cmd
        assert ours.instructions(cmd) == theirs.instructions(cmd), cmd
    assert ours.plan("please open the drawer and turn on the led")[:1] == ["open_drawer"]
    fixed = lambda prompt: "turn_off_lightbulb()\nclose_drawer()"  # noqa: E731
    assert (llm_planning.LLMPlanner(fixed).plan("x") == jax_planning.LLMPlanner(fixed).plan("x")
            == ["turn_off_lightbulb", "close_drawer"])


# ---- results.json ----------------------------------------------------- #
def test_print_and_save_ranks_every_step(tmp_path, capsys):
    """One call on an empty dir writes JAX's file byte for byte. A second
    call with a worse step: JAX names it "best" (it ranks only the current
    call's steps), the port keeps the better earlier step."""
    seqs = sequences.get_sequences(10)
    good, bad = [3, 2, 4, 1, 5, 2, 3, 4, 0, 2], [0, 1, 0, 0, 2, 0, 1, 0, 0, 0]
    for module, d in ((harness, tmp_path / "ours"), (jax_harness, tmp_path / "jax")):
        module.print_and_save({"20": good}, d, sequences=seqs)
    assert ((tmp_path / "ours" / "results.json").read_text()
            == (tmp_path / "jax" / "results.json").read_text())
    ours = harness.print_and_save({"40": bad}, tmp_path / "ours", sequences=seqs)
    theirs = jax_harness.print_and_save({"40": bad}, tmp_path / "jax", sequences=seqs)
    assert theirs["best"]["epoch"] == "40"
    assert ours["best"]["epoch"] == "20" and ours["best"]["avg_seq_len"] == np.mean(good)
    assert {k: v for k, v in ours.items() if k != "best"} == {
        k: v for k, v in theirs.items() if k != "best"}
    f = tmp_path / "ours" / "results.json"
    assert json.loads(f.read_text()) == json.loads(json.dumps(ours))
    capsys.readouterr()
    assert harness.best_eval_model(f) == jax_harness.best_eval_model(f) == "20"
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == out[3:] and out[0] == "20"


def test_harness_cli_prints_the_best_step(tmp_path):
    import subprocess
    import sys

    seqs = sequences.get_sequences(4)
    harness.print_and_save({"5": [1, 0, 2, 0], "9": [3, 1, 2, 2]}, tmp_path, sequences=seqs)
    out = subprocess.run([sys.executable, "-m", "hulc2_torch.evaluation.harness", "-f",
                          str(tmp_path / "results.json")], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[:2] == ["9", "2.0"]


# ---- the CLI protocols on the CPU ------------------------------------- #
def _spy_evaluator(monkeypatch):
    made = []

    class Spy(batched_eval.PipelinedEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(batched_eval, "PipelinedEvaluator", Spy)
    return made


def test_cli_paraphrase_tables_equal_jax(tmp_path, monkeypatch):
    """``--paraphrase-eval`` with a detector: the policy's and the detector's
    variants are the held-out sentences' token ids (JAX's tokenizer gives the
    same rows), the detector's caption table holds canonical and held-out
    sentences, and eval_diagnostics.json says so."""
    from hulc2_tpu.tools.annotations import heldout_annotations as jax_heldout
    from hulc2_tpu.utils.clip_tokenizer import tokenize as jax_tokenize
    from hulc2_torch.affordance import train_affordance
    from hulc2_torch.evaluation import evaluate_policy
    from hulc2_torch.tools.annotations import VALIDATION_BANK
    from test_torch_port_hierarchical import AFF_TINY

    monkeypatch.setenv("HULC2_SEQUENCES_CACHE_DIR", str(tmp_path))
    train_affordance.main(["--synthetic", "--device", "cpu", "--max-steps", "1",
                           "--run-dir", str(tmp_path / "aff"), *AFF_TINY])
    made = _spy_evaluator(monkeypatch)
    evaluate_policy.main(["--synthetic", "--fake-env", "--device-render", "--n-envs", "3",
                          "--cohorts", "2", "--num-sequences", "5", "--ep-len", "3",
                          "--paraphrase-eval", "--aff-train-dir", str(tmp_path / "aff"),
                          "--log-dir", str(tmp_path / "ev"), "--device", "cpu", *TINY])
    (ev,) = made
    for t in tasks.TASK_NAMES:
        want = jax_tokenize(jax_heldout(t))
        assert len(ev.lang_variants[t]) == len(ev.aff_lang_variants[t]) == len(want) == 4
        for got, aff, w in zip(ev.lang_variants[t], ev.aff_lang_variants[t], want):
            np.testing.assert_array_equal(got, w)
            np.testing.assert_array_equal(aff, w)
        table = ev.affordance.lang_table
        np.testing.assert_array_equal(table[VALIDATION_BANK[t]], jax_tokenize([VALIDATION_BANK[t]])[0])
        for s, w in zip(jax_heldout(t), want):
            np.testing.assert_array_equal(table[s], w)
    diag = json.loads((tmp_path / "ev" / "eval_diagnostics.json").read_text())
    assert diag["paraphrase_eval"] is True and diag["hierarchical"]["aff_predictions"] > 0
    evaluate_policy.main(["--synthetic", "--fake-env", "--n-envs", "2", "--num-sequences", "2",
                          "--ep-len", "2", "--log-dir", str(tmp_path / "ev0"), "--device", "cpu",
                          *TINY])
    assert made[1].lang_variants is None
    assert json.loads((tmp_path / "ev0" / "eval_diagnostics.json").read_text())[
        "paraphrase_eval"] is False


def test_cli_single_step(tmp_path, monkeypatch, expert_dir, caplog):
    """With a dataset: one job per detected validation window, one subtask
    each, one record per job. Without one: a warning, and the first subtask
    of each generated chain."""
    from hulc2_torch.evaluation import evaluate_policy

    monkeypatch.setenv("HULC2_SEQUENCES_CACHE_DIR", str(tmp_path))
    made = _spy_evaluator(monkeypatch)
    run = _tiny_run(tmp_path / "run")
    jobs = harness.dataset_singlestep_sequences(expert_dir / "validation")
    merged = evaluate_policy.main(["--train-dir", str(run), "--fake-env", "--device-render",
                                   "--single-step", "--dataset-path", str(expert_dir),
                                   "--n-envs", "2", "--ep-len", "3", "--device", "cpu"])
    diag = json.loads((run / "evaluation" / "eval_diagnostics.json").read_text())
    assert diag["num_sequences"] == len(jobs) == len(diag["subtask_records"]) == 5
    assert [c for _, c in made[0].sequences] == [c for _, c in jobs]
    assert sorted(r["chain"] for r in diag["subtask_records"]) == list(range(len(jobs)))
    assert all(r["pos"] == 0 for r in diag["subtask_records"])
    assert merged["latest"]["chain_sr"][2] == 0.0
    with caplog.at_level(logging.WARNING, logger="hulc2_torch.evaluation.evaluate_policy"):
        evaluate_policy.main(["--train-dir", str(run), "--fake-env", "--single-step",
                              "--dataset-path", str(tmp_path / "none"), "--num-sequences", "3",
                              "--n-envs", "2", "--ep-len", "2", "--device", "cpu",
                              "--log-dir", str(tmp_path / "ev")])
    assert any("without a dataset validation split" in r.getMessage() for r in caplog.records)
    assert [c for _, c in made[1].sequences] == [c[:1] for _, c in sequences.get_sequences(3)]


def test_all_checkpoints_passes_every_flag_on(tmp_path, monkeypatch):
    """``--all-checkpoints`` over a two-checkpoint run on the CPU: each step
    gets ``--device-render``, ``--paraphrase-eval``, ``--log-dir`` and
    ``--device``, and both land in one results.json. The JAX sweep's parser
    rejects the flags its ``evaluate_policy`` hands it."""
    from hulc2_tpu.evaluation import run_multiple as jax_run_multiple
    from hulc2_torch.evaluation import evaluate_policy, run_multiple

    monkeypatch.setenv("HULC2_SEQUENCES_CACHE_DIR", str(tmp_path))
    run = _tiny_run(tmp_path / "run")
    calls = []
    real_main = evaluate_policy.main

    def spy(argv):
        calls.append(list(argv))
        return real_main(argv)

    monkeypatch.setattr(evaluate_policy, "main", spy)
    log_dir = tmp_path / "sweep"
    flags = ["--fake-env", "--device-render", "--paraphrase-eval", "--n-envs", "2",
             "--num-sequences", "2", "--ep-len", "2", "--log-dir", str(log_dir), "--device", "cpu"]
    merged = real_main(["--train-dir", str(run), "--all-checkpoints", *flags])
    assert [c[:4] for c in calls] == [["--train-dir", str(run), "--checkpoint", s] for s in "12"]
    assert all(c[4:] == flags for c in calls)
    results = json.loads((log_dir / "results.json").read_text())
    assert set(results) == {"1", "2", "best"} and json.loads(json.dumps(merged)) == results
    assert results["best"]["avg_seq_len"] == max(results[s]["avg_seq_len"] for s in "12")
    diag = json.loads((log_dir / "eval_diagnostics.json").read_text())
    assert diag["paraphrase_eval"] is True and diag["device_render"] is True
    assert not (run / "evaluation").exists()
    assert run_multiple.list_checkpoints(run) == [1, 2]
    for extra in (["--device-render"], ["--paraphrase-eval"], ["--log-dir", str(log_dir)]):
        with pytest.raises(SystemExit):
            jax_run_multiple.main(["--train-dir", str(run), "--fake-env", *extra])


def test_run_multiple_workers_merge_one_file(tmp_path):
    """``--workers 2``: each step in its own process, both in one results.json."""
    import os
    import subprocess
    import sys

    run = _tiny_run(tmp_path / "run")
    env = {**os.environ, "HULC2_SEQUENCES_CACHE_DIR": str(tmp_path),
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-m", "hulc2_torch.evaluation.run_multiple",
                          "--train-dir", str(run), "--workers", "2", "--fake-env", "--n-envs", "1",
                          "--num-sequences", "1", "--ep-len", "2", "--device", "cpu"],
                         capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    results = json.loads((run / "evaluation" / "results.json").read_text())
    assert set(results) == {"1", "2", "best"}


def test_cli_refuses_protocol_misuse(tmp_path):
    from hulc2_torch.evaluation import evaluate_policy, run_multiple

    run = _tiny_run(tmp_path / "run", steps=(1,))
    no_tower = _tiny_run(tmp_path / "no_tower", steps=(1,),
                         model={"language_encoder": {"_name_": "none"}})
    for argv in (["--synthetic", "--all-checkpoints", "--fake-env"],
                 ["--train-dir", str(run), "--all-checkpoints", "--checkpoint", "1", "--fake-env"],
                 ["--train-dir", str(run), "--fake-env", "--dataset-path", str(tmp_path)],
                 ["--train-dir", str(no_tower), "--fake-env", "--paraphrase-eval"]):
        with pytest.raises(SystemExit):
            evaluate_policy.main(argv + ["--device", "cpu"])
    for argv in (["--train-dir", str(run), "--checkpoint", "1"],
                 ["--train-dir", str(run), "--all-checkpoints"],
                 ["--train-dir", str(tmp_path / "missing")]):
        with pytest.raises(SystemExit):
            run_multiple.main(argv + ["--fake-env", "--device", "cpu"])


# ---- the interactive entry point --------------------------------------- #
def test_interactive_on_cpu(tmp_path, capsys):
    """Two instructions on a StringIO stdin, one from the keyword planner:
    one verdict line each, then an empty line ends the loop."""
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import interactive

    run = _tiny_run(tmp_path / "run")
    planned = llm_planning.LLMPlanner().instructions("turn on the led")
    assert planned == ["turn on the led"]
    before = dict(kernels.LAUNCHES)
    stdin = io.StringIO(f"open the drawer\n{planned[0]}\n\nnever read\n")
    verdicts = interactive.main(["--train-dir", str(run), "--fake-env", "--ep-len", "4",
                                 "--device", "cpu"], stdin=stdin)
    assert kernels.LAUNCHES == before  # the CPU runs the plain versions
    assert [v[0] for v in verdicts] == ["open the drawer", "turn on the led"]
    assert all(1 <= v[2] <= 4 and (v[1] is None or v[1] in tasks.TASK_NAMES) for v in verdicts)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("-> ")]
    assert lines == [f"-> {'completed ' + v[1] if v[1] else 'no task completed'} ({v[2]} steps)"
                     for v in verdicts]


def test_interactive_refuses(tmp_path):
    import torch

    from hulc2_torch.evaluation import interactive

    run = _tiny_run(tmp_path / "run", steps=(1,))
    no_tower = _tiny_run(tmp_path / "no_tower", steps=(1,),
                         model={"language_encoder": {"_name_": "none"}})
    for argv in (["--train-dir", str(run)], ["--train-dir", str(tmp_path / "missing"), "--fake-env"],
                 ["--train-dir", str(no_tower), "--fake-env"]):
        with pytest.raises(SystemExit):
            interactive.main(argv + ["--device", "cpu"], stdin=io.StringIO("x\n"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            interactive.main(["--train-dir", str(run), "--fake-env"], stdin=io.StringIO("x\n"))


# ---- the annotator's lookback ------------------------------------------ #
@pytest.mark.parametrize("split", ["training", "validation"])
def test_annotator_windows(expert_dir, split):
    """At the default 64 frames the hits equal JAX's; at 20 the port finds
    hits where the JAX loop's empty lookback range drops every one."""
    from hulc2_tpu.tools.auto_lang_annotator import detect_task_windows as jax_detect
    from hulc2_torch.data.episode_index import load_ep_start_end_ids
    from hulc2_torch.data.frame_store import NpzFrameStore
    from hulc2_torch.tools.auto_lang_annotator import detect_task_windows

    d = expert_dir / split
    store, ids = NpzFrameStore(d, ["scene_obs"]), load_ep_start_end_ids(d, split)
    assert detect_task_windows(store, ids) == jax_detect(store, ids)
    short = detect_task_windows(store, ids, window=20)
    assert jax_detect(store, ids, window=20) == [] and len(short) >= 2
    for h in short:
        s, e = h["indx"]
        assert 10 <= e - s <= 19 and h["task"] in tasks.TASK_NAMES
    with pytest.raises(ValueError, match="at least 8 frames"):
        detect_task_windows(store, ids, window=7)


def test_short_lang_window_annotates(tmp_path):
    """``make_expert_dataset --lang-window 20`` writes annotations (the JAX
    loop drops every hit at that window)."""
    from hulc2_torch.tools import make_expert_dataset

    make_expert_dataset.main([str(tmp_path), "--episodes", "1", "--tasks-per-episode", "2",
                              "--val-episodes", "0", "--lang-window", "20", "--seed", "1"])
    ann = np.load(tmp_path / "training" / "lang_annotations" / "auto_lang_ann.npy",
                  allow_pickle=True).item()
    assert len(ann["language"]["task"]) >= 1
