"""The port's optimizers, learning-rate schedules and gradient clipping against
the JAX package's optax transforms (``hulc2_tpu/train/optim.py``), on the CPU.

The learning rate of every update for each optimizer and schedule over 50
updates across the warm-up boundary, atol 1e-7 against optax; the
parameters after 5 updates with clipping by the global norm (steps above
and below the norm), rtol 1e-5; the schedule's state in a checkpoint; and
the trainer with a warm-up schedule, AdamW and clipping: the logged ``lr``
is JAX's, and a resumed run equals an uninterrupted one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from hulc2_tpu.train import optim as joptim
from hulc2_torch.core.checkpoint import CheckpointManager
from hulc2_torch.train import optim
from test_torch_port_trainer import _fit, _losses, calvin96, disk_config  # noqa: F401

OPTIMIZERS = {"adam": {"kind": "adam", "lr": 2e-3},
              "adamw": {"kind": "adamw", "lr": 2e-3, "weight_decay": 0.05},
              "sgd": {"kind": "sgd", "lr": 2e-3, "momentum": 0.9}}
SCHEDULES = {"constant": {"kind": "constant"},
             "linear_warmup": {"kind": "linear_warmup", "num_warmup_steps": 0.1,
                               "num_training_steps": -1},
             "cosine_warmup": {"kind": "cosine", "num_warmup_steps": 0.1,
                               "num_training_steps": -1}}
CASES = [(o, s) for o in OPTIMIZERS for s in SCHEDULES]
IDS = [f"{o}-{s}" for o, s in CASES]
TOTAL = 40  # estimated updates: warm-up 4, cosine over 36, then held at its end


@pytest.mark.parametrize("opt,sched", CASES, ids=IDS)
def test_learning_rate_sequence_matches_optax(opt, sched):
    """Update k's learning rate as optax applies it (the schedule at the
    count before the update, so the first warm-up update uses 0), from
    ``make_schedule``, ``schedule_value`` and the optimizer's group under
    ``make_scheduler``, over 50 updates: atol 1e-7."""
    opt_cfg, sched_cfg = OPTIMIZERS[opt], SCHEDULES[sched]
    want_fn = joptim.make_schedule(sched_cfg, opt_cfg["lr"], TOTAL)
    want = [float(want_fn(k)) for k in range(50)]
    fn = optim.make_schedule(sched_cfg, opt_cfg["lr"], TOTAL)
    np.testing.assert_allclose([fn(k) for k in range(50)], want, atol=1e-7, rtol=0)
    np.testing.assert_allclose([optim.schedule_value(opt_cfg, sched_cfg, k, TOTAL) for k in range(50)],
                               [joptim.schedule_value(opt_cfg, sched_cfg, k, TOTAL) for k in range(50)],
                               atol=1e-7, rtol=0)
    p = torch.nn.Parameter(torch.zeros(3))
    o = optim.make_optimizer([p], opt_cfg)
    s = optim.make_scheduler(o, opt_cfg, sched_cfg, TOTAL)
    used = []
    for _ in range(50):
        used.append(o.param_groups[0]["lr"])
        p.grad = torch.ones(3)
        o.step()
        s.step()
    np.testing.assert_allclose(used, want, atol=1e-7, rtol=0)
    if sched != "constant":
        assert used[0] == 0.0 and max(used) == pytest.approx(opt_cfg["lr"])


def _grads(rng, step: int) -> dict:
    """Gradients whose global norm is ~8 on even steps, ~0.3 on odd ones."""
    scale = 2.0 if step % 2 == 0 else 0.08
    return {"w": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "b": (rng.standard_normal((5,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("opt,sched", CASES, ids=IDS)
def test_five_clipped_updates_match_optax(opt, sched):
    """``gradient_clip_norm=1`` before the update, as optax chains
    ``clip_by_global_norm``; schedules over 10 estimated updates (warm-up 1):
    parameters after each of 5 updates, rtol 1e-5."""
    opt_cfg = {**OPTIMIZERS[opt], "gradient_clip_norm": 1.0}
    sched_cfg = SCHEDULES[sched]
    rng = np.random.default_rng(len(opt) + len(sched))
    init = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    tx = joptim.make_optimizer(opt_cfg, sched_cfg, 10)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    o = optim.make_optimizer(list(tparams.values()), opt_cfg)
    s = optim.make_scheduler(o, opt_cfg, sched_cfg, 10)
    norms = []
    for step in range(5):
        g = _grads(rng, step)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        grads = [p.grad for p in tparams.values()]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(x) for x in grads]))
        norms.append(float(norm))
        optim.clip_gradients_(grads, norm, opt_cfg["gradient_clip_norm"])
        o.step()
        s.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"update {step} {k}")
    assert max(norms) > 1.0 > min(norms)  # both sides of the clip


def test_clip_scales_only_above_the_norm():
    g = [torch.full((4,), 3.0), torch.full((9,), 4.0)]
    norm = torch.linalg.vector_norm(torch.cat(g))
    optim.clip_gradients_(g, norm, 2.0)
    assert torch.linalg.vector_norm(torch.cat(g)).item() == pytest.approx(2.0, rel=1e-6)
    small = [torch.full((4,), 0.1)]
    optim.clip_gradients_(small, torch.linalg.vector_norm(small[0]), 2.0)
    assert torch.equal(small[0], torch.full((4,), 0.1))


def test_warmup_resolution_and_refusals():
    assert optim.compute_warmup(-1, 0.1, 200) == joptim.compute_warmup(-1, 0.1, 200) == (200, 20)
    assert optim.compute_warmup(50, 7, 200) == (50, 7)
    # a warm-up of 0 updates holds optax's linear schedule at its start, 0
    lin = {"kind": "linear_warmup", "num_warmup_steps": 0, "num_training_steps": 10}
    assert optim.make_schedule(lin, 1e-3, 10)(5) == float(joptim.make_schedule(lin, 1e-3, 10)(5)) == 0
    with pytest.raises(ValueError):
        optim.make_schedule({"kind": "cosine", "num_warmup_steps": 10, "num_training_steps": 10},
                            1e-3)
    for bad_opt, bad_sched in (({"kind": "lamb"}, None), ({"kind": "adam"}, {"kind": "step"})):
        with pytest.raises(ValueError):
            optim.make_scheduler(optim.make_optimizer([torch.nn.Parameter(torch.zeros(1))],
                                                      bad_opt), bad_opt, bad_sched)


def test_scheduler_state_survives_a_checkpoint(tmp_path):
    """A cosine schedule stepped 7 times, saved with its optimizer and
    restored into fresh ones, goes on exactly as the uninterrupted one."""
    opt_cfg, sched_cfg = OPTIMIZERS["adamw"], SCHEDULES["cosine_warmup"]

    def fresh():
        model = torch.nn.Linear(3, 2)
        o = optim.make_optimizer(model.parameters(), opt_cfg)
        return model, o, optim.make_scheduler(o, opt_cfg, sched_cfg, TOTAL)

    def advance(model, o, s, n):
        lrs = []
        for _ in range(n):
            lrs.append(o.param_groups[0]["lr"])
            model(torch.ones(1, 3)).sum().backward()
            o.step()
            s.step()
            o.zero_grad()
        return lrs

    torch.manual_seed(0)
    whole = fresh()
    state0 = {k: v.clone() for k, v in whole[0].state_dict().items()}
    lrs_whole = advance(*whole, 12)
    cut = fresh()
    cut[0].load_state_dict(state0)
    advance(*cut, 7)
    CheckpointManager(tmp_path).save(7, cut[0], cut[1], scheduler=cut[2])
    restored = CheckpointManager(tmp_path).restore()
    again = fresh()
    again[0].load_state_dict(restored["model"])
    again[1].load_state_dict(restored["optimizer"])
    again[2].load_state_dict(restored["scheduler"])
    assert advance(*again, 5) == lrs_whole[7:]
    assert all(torch.equal(whole[0].state_dict()[k], again[0].state_dict()[k])
               for k in state0)


def test_trainer_schedule_logs_and_resumes(calvin96, tmp_path):  # noqa: F811
    """AdamW with a cosine warm-up of 2 updates over 10 and clipping at 1 in
    the trainer: each logged ``lr`` is JAX's ``schedule_value`` at the step
    (the trainer's estimate is steps_per_epoch x training.max_epochs when
    num_training_steps is -1); two epochs of two steps in one run and the
    same run resumed after the first epoch have equal losses, lrs and
    parameters."""
    extra = ["model/optimizer=adamw", "model/lr_scheduler=cosine_warmup",
             "model.lr_scheduler.num_warmup_steps=2", "model.lr_scheduler.num_training_steps=10",
             "model.optimizer.gradient_clip_norm=1.0"]
    cfg = disk_config(calvin96, *extra)
    whole = _fit(cfg, tmp_path / "whole", max_epochs=2)
    lrs = [line["train/lr"] for line in whole.history]
    mc = cfg["model"]
    want = [joptim.schedule_value(mc["optimizer"], mc["lr_scheduler"], k, 0) for k in (1, 2, 3, 4)]
    np.testing.assert_allclose(lrs, want, atol=1e-9, rtol=0)  # JAX evaluates in fp32
    assert lrs[0] < lrs[1] == pytest.approx(mc["optimizer"]["lr"])
    _fit(cfg, tmp_path / "cut", max_epochs=1)
    resumed = _fit(cfg, tmp_path / "cut", max_epochs=2)
    assert resumed.resumed_from == 2
    assert _losses(resumed) == _losses(whole)[2:]
    assert [line["train/lr"] for line in resumed.history] == lrs[2:]
    want_sd, got_sd = whole.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(want_sd[k], got_sd[k]) for k in want_sd)
    # the trainer's own estimate: the uncut epoch times the config's max_epochs
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.train.trainer import Trainer

    dm = Hulc2DataModule(cfg["datamodule"], seed=cfg["seed"], device="cpu")
    dm.setup()
    trainer = Trainer(cfg, dm, None, device="cpu")
    assert trainer.estimated_total == dm.steps_per_epoch() * cfg["training"]["max_epochs"]
