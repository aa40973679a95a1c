"""The port's train step against the JAX package's, and the port's isolation.

Three fused train steps (transform, forward, backward, Adam) from the same
weights, batches, crop offsets and Gumbel draws must track the JAX losses;
the port must not import JAX or the JAX package; its entry points must
refuse to run without a card unless the CPU is asked for.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_common import (
    build_both, install_gumbel_rsample, jax_batch, jax_train_step_fn, make_draws, make_raw_batch,
    shift_draws, small_config, torch_raw,
)
from hulc2_torch import training
from hulc2_torch.data.device_transforms import make_batch_transform
from hulc2_torch.train.optim import make_optimizer
from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step

REPO = Path(__file__).resolve().parents[1]
TINY = [
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.visual_goal.hidden_size=32",
    "model.language_goal.hidden_size=32", "model.action_decoder.hidden_size=32",
    "model.language_encoder.width=32", "model.language_encoder.heads=2",
    "datamodule.batch_size_vis=2", "datamodule.batch_size_lang=2", "datamodule.max_window_size=4",
]


def test_three_train_steps_track_jax(monkeypatch):
    holder = install_gumbel_rsample(monkeypatch)
    cfg = small_config()
    jmodel, params, tmodel = build_both(cfg, seed=1)
    loss_cfg, lr = cfg["loss"], cfg["model"]["optimizer"]["lr"]
    n_vis = cfg["datamodule"]["batch_size_vis"]
    tx, jstep = jax_train_step_fn(jmodel, lr, loss_cfg["clip_auxiliary_loss_beta"],
                                  loss_cfg["lang_task_auxiliary_loss_beta"], n_vis, holder)
    opt_state = tx.init(params)

    dm = cfg["datamodule"]
    tf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"], dm["transforms"])
    opt = make_optimizer(tmodel.parameters(), cfg["model"]["optimizer"])
    tstep = make_train_step(tmodel, opt, tf, loss_cfg["clip_auxiliary_loss_beta"],
                            aux_betas_from_loss_cfg(loss_cfg), device="cpu")
    rng = np.random.default_rng(21)
    for i in range(3):
        raw = make_raw_batch(rng, cfg)
        offsets, gumbel = make_draws(rng, cfg)
        params, opt_state, want = jstep(params, opt_state, jax_batch(raw, offsets),
                                        jnp.asarray(gumbel), loss_cfg["kl_beta"])
        got = tstep(torch_raw(raw), None, loss_cfg["kl_beta"], gumbel=torch.from_numpy(gumbel),
                    draws=shift_draws(offsets))
        for k in ("loss", "total_loss", "action_loss", "kl_loss", "lang_clip_loss",
                  "lang_task_loss", "grad_norm"):
            # fp32 both sides; Adam's first update amplifies near-zero gradients
            # (sign flips of ~1e-9 components move a weight by a full lr)
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3, atol=1e-5,
                                       err_msg=f"step {i} {k}")


def test_action_bounds_are_buffers_and_the_step_makes_none(monkeypatch):
    """The decoder's continuous-dim bounds are non-persistent buffers that
    move with the module, and a train step builds no tensor on a device from
    host values (on the card that is a pageable copy, which synchronises the
    stream)."""
    from hulc2_torch.models.build import build_policy

    cfg = small_config()
    model = build_policy(cfg["model"], seed=1)
    dec = model.action_decoder
    lo, hi = dec.bounds()
    buffers = dict(model.named_buffers())
    assert lo is buffers["action_decoder.act_min"] and hi is buffers["action_decoder.act_max"]
    assert not {"action_decoder.act_min", "action_decoder.act_max"} & set(model.state_dict())
    np.testing.assert_array_equal(lo[:, 0].numpy(), np.float32(dec.act_min_bound[:-1]))
    np.testing.assert_array_equal(hi[:, 0].numpy(), np.float32(dec.act_max_bound[:-1]))

    dm, loss_cfg = cfg["datamodule"], cfg["loss"]
    tf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"], dm["transforms"])
    step = make_train_step(model, make_optimizer(model.parameters(), cfg["model"]["optimizer"]), tf,
                           loss_cfg["clip_auxiliary_loss_beta"], aux_betas_from_loss_cfg(loss_cfg),
                           device="cpu")
    rng = np.random.default_rng(5)
    step(torch_raw(make_raw_batch(rng, cfg)), torch.Generator().manual_seed(0), 0.01)
    made, real = [], torch.tensor

    def watched(*args, **kwargs):
        if kwargs.get("device") is not None:
            made.append(kwargs["device"])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "tensor", watched)
    step(torch_raw(make_raw_batch(rng, cfg)), torch.Generator().manual_seed(1), 0.01)
    assert made == []


def test_import_leaves_jax_out():
    code = ("import sys; sys.path.insert(0, {repo!r}); import hulc2_torch, hulc2_torch.training, "
            "hulc2_torch.evaluation.evaluate_policy, hulc2_torch.agents.hulc2_agent, "
            "hulc2_torch.envs.render_torch, hulc2_torch.tools.profile_eval, "
            "hulc2_torch.tools.make_expert_dataset, hulc2_torch.evaluation.loading, "
            "hulc2_torch.train.trainer, hulc2_torch.data.datamodule, "
            "chip_smoke; bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('hulc2_tpu')); print(bad); sys.exit(1 if bad else 0)").format(repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((REPO / "hulc2_torch").rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hulc2_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_refuse_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is what a CPU-only host sees")
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(model, torch.optim.Adam(model.parameters()), lambda *a: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(model, torch.optim.Adam(model.parameters()), lambda *a: None, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        training.main(["--synthetic", "--max-steps", "1", *TINY])


def test_cli_runs_on_cpu_when_asked(tmp_path):
    result = training.main(["--synthetic", "--max-steps", "2", "--device", "cpu",
                            "--run-dir", str(tmp_path), *TINY])
    lines = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [line["step"] for line in lines] == [0, 1]
    for line in lines:
        assert all(np.isfinite(v) for v in line.values())
        assert line["step_ms"] > 0
    assert result.history == lines
