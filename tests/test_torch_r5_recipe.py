"""The round-5 flagship run of the port (``docs/runs/r5_flagship_torch/run.sh``)
is the recipe of the JAX package's r5 run, on the CPU and in well under 5 s.

Each stage's command of ``run.sh`` goes through the port's own argument
parser (its ``main``, with the work behind it replaced by a recorder), so a
renamed flag fails here and not hours into a card run. The commands are the
r5 README's ``Reproduce`` block with ``hulc2_tpu`` -> ``hulc2_torch``, the
paths moved to the run's work dir, the paraphrase protocol added, and one
flag added to the generator, ``--unaligned-lang-windows`` (the r5 dataset
was annotated before the JAX package aligned its language windows;
``tests/test_torch_port_data.py`` holds that annotation to JAX's). The
configs the two trainers compose from
those commands equal the r5 run's recorded ``policy_config.json`` and
``aff_config.json`` key for key, but for the data paths (and the labels'
depth normalisation, which the detector's trainer adds from the data).
"""
import json
import re
import shlex
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
R5 = REPO / "docs" / "runs" / "r5_flagship"
RUN_SH = REPO / "docs" / "runs" / "r5_flagship_torch" / "run.sh"
WORK = "/work"


def _expand(cmd: str, name: str = "", extra: str = "") -> list:
    for var, value in (("$AFF_DATA", f"{WORK}/calvin_expert_r5_aff"),
                       ("$DATA", f"{WORK}/calvin_expert_r5"),
                       ("$WORK", WORK), ("$name", name), ('"${extra[@]}"', extra)):
        cmd = cmd.replace(var, value)
    return shlex.split(cmd)


def run_sh_commands() -> dict:
    """{stage: argv after ``python -m``} of every stage of ``run.sh``."""
    text = RUN_SH.read_text().replace("\\\n", " ")
    cmds = {}
    for m in re.finditer(r'^\s*stage "?(\$s|\d)"? \S+ python -m (.*?)(?:\s*\|\| rc=\$\?)?$', text,
                         re.M):
        if m.group(1) == "$s":
            cmds[5] = _expand(m.group(2), "eval_1000")
            cmds[6] = _expand(m.group(2), "eval_1000_paraphrase", "--paraphrase-eval")
        else:
            cmds[int(m.group(1))] = _expand(m.group(2))
    return cmds


def readme_commands() -> dict:
    """{stage: argv after ``python -m``} of the r5 README's ``Reproduce``
    block, with the port's package and the run's paths."""
    text = (R5 / "README.md").read_text()
    block = text[text.index("## Reproduce"):].split("```")[1].replace("\\\n", " ")
    paths = {"runs/calvin_expert_r5_aff": f"{WORK}/calvin_expert_r5_aff",
             "runs/calvin_expert_r5": f"{WORK}/calvin_expert_r5",
             "runs/r5/policy_v2": f"{WORK}/policy", "runs/r5/aff": f"{WORK}/aff",
             "runs/r5/eval_1000": f"{WORK}/eval_1000"}
    stages = {"tools.make_expert_dataset": 1, "affordance.dataset_creation": 2, "training": 3,
              "affordance.train_affordance": 4, "evaluation.evaluate_policy": 5}
    cmds = {}
    for line in block.splitlines():
        if not line.startswith("python -m hulc2_tpu."):
            continue
        for old, new in paths.items():
            line = line.replace(old, new)
        argv = shlex.split(line.replace("hulc2_tpu.", "hulc2_torch."))[2:]
        cmds[stages[argv[0][len("hulc2_torch."):]]] = argv
    return cmds


def test_run_sh_is_the_r5_recipe():
    got, want = run_sh_commands(), readme_commands()
    assert sorted(got) == [1, 2, 3, 4, 5, 6] and sorted(want) == [1, 2, 3, 4, 5]
    assert got[1] == want[1] + ["--unaligned-lang-windows"]
    for s in (2, 3, 4, 5):
        assert got[s] == want[s], s
    assert got[6] == [a.replace("eval_1000", "eval_1000_paraphrase") for a in want[5]] + [
        "--paraphrase-eval"]


def _diff(got, want, path=""):
    """Every dotted key where two configs differ (lists and tuples alike)."""
    if isinstance(got, dict) and isinstance(want, dict):
        return [d for k in sorted(set(got) | set(want), key=str)
                for d in (_diff(got[k], want[k], f"{path}{k}.") if k in got and k in want
                          else [f"{path}{k}"])]
    if isinstance(got, (list, tuple)) and isinstance(want, (list, tuple)):
        got, want = list(got), list(want)
    return [] if got == want else [path.rstrip(".")]


class _Stop(Exception):
    pass


def _recorder(calls, stop=False):
    def record(*args, **kwargs):
        calls.append((args, kwargs))
        if stop:
            raise _Stop
    return record


def test_generator_and_miner_commands_parse(monkeypatch, tmp_path):
    from hulc2_torch.affordance import dataset_creation
    from hulc2_torch.tools import make_expert_dataset

    cmds = run_sh_commands()
    calls = []
    monkeypatch.setattr(make_expert_dataset, "make_expert_dataset", _recorder(calls))
    make_expert_dataset.main(cmds[1][1:])
    (args, kwargs), = calls
    assert args == (f"{WORK}/calvin_expert_r5", 200, 24, 8, 12, 96, 64, 0.03)
    assert kwargs["seed"] == 0 and kwargs["lang_tokens"] and kwargs["holdout_paraphrases"] == 4
    assert kwargs["balance_tasks"]
    assert kwargs["align_lang_windows"] is False

    calls.clear()
    monkeypatch.setattr(dataset_creation, "create_split_file", _recorder(calls))
    argv = [a.replace(WORK, str(tmp_path)) for a in cmds[2][1:]]
    dataset_creation.main(argv)
    (args, _), = calls
    assert args[0] == f"{tmp_path}/calvin_expert_r5_aff"


def test_policy_command_composes_the_r5_config(monkeypatch):
    from hulc2_torch import training

    calls = []
    monkeypatch.setattr(training, "fit", _recorder(calls))
    training.main(run_sh_commands()[3][1:])
    (args, _), = calls
    cfg, run_dir, max_epochs = args[:3]
    assert (run_dir, max_epochs) == (f"{WORK}/policy", 8)
    recorded = json.loads((R5 / "policy_config.json").read_text())
    assert _diff(cfg, recorded) == ["datamodule.root_data_dir"]
    assert cfg["datamodule"]["root_data_dir"] == f"{WORK}/calvin_expert_r5"


def test_detector_command_composes_the_r5_config(monkeypatch):
    from hulc2_torch.affordance import train_affordance
    from hulc2_torch.configs.affordance import affordance_config

    calls = []
    monkeypatch.setattr(train_affordance, "train", _recorder(calls))
    train_affordance.main(run_sh_commands()[4][1:])
    (args, _), = calls
    overrides, max_epochs, _, synthetic, run_dir = args[:5]
    assert (max_epochs, synthetic, run_dir) == (15, False, f"{WORK}/aff")
    cfg = affordance_config(overrides)
    recorded = json.loads((R5 / "aff_config.json").read_text())
    assert _diff(cfg, recorded) == ["aff_detection.dataset.data_dir", "depth_norm"]
    assert cfg["aff_detection"]["dataset"]["data_dir"] == f"{WORK}/calvin_expert_r5_aff"


@pytest.mark.parametrize("stage", [5, 6])
def test_eval_commands_parse(monkeypatch, stage):
    """Both protocols pass the evaluator's checks on a flagship policy run
    and an ``rn18_tokens_pixel`` detector run, up to the chain generation."""
    from hulc2_torch.configs.affordance import affordance_config
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.core import checkpoint
    from hulc2_torch.evaluation import evaluate_policy

    configs = {f"{WORK}/policy": flagship_config(),
               f"{WORK}/aff": affordance_config(["aff_detection=rn18_tokens_pixel"])}
    checked, calls = [], []
    monkeypatch.setattr(evaluate_policy, "check_run_dir",
                        lambda p, run_dir, step, *a: checked.append(str(run_dir)))
    monkeypatch.setattr(checkpoint, "load_run_config", lambda run_dir: configs[str(run_dir)])
    monkeypatch.setattr(evaluate_policy, "get_sequences", _recorder(calls, stop=True))
    with pytest.raises(_Stop):
        evaluate_policy.main(run_sh_commands()[stage][1:])
    assert checked == [f"{WORK}/policy", f"{WORK}/aff"]
    assert calls == [((1000,), {})]
