"""The train step replayed as a CUDA graph (``hulc2_torch/train/steps.py``,
``StepGraphs``) and the capturable optimizer it needs (``train/optim.py``).

On the CPU: when the graph engages (never on the CPU, with given draws or
in a data-parallel rank) and what ``train.eager_steps`` counts; a
device-scalar KL beta and a learning rate in a tensor give the floats'
losses and parameters; ``make_optimizer`` is fused and capturable only on
the card; the batch signature. On the card (``-m cuda``; torch only, so the
card's machine runs them with ``--noconftest``): replays against the eager
step, the KL beta and the schedule reaching the replay, metrics that outlive
the next replay, a second signature's graph, the counters, the replayed
kernel on the device trace and the memory peak.
"""
from __future__ import annotations

import gc

import pytest
import torch

from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.core import trace
from hulc2_torch.data.device_transforms import make_batch_transform
from hulc2_torch.train import optim, steps
from hulc2_torch.training import SyntheticRun

TINY = [  # test_torch_port_trace.TINY
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.visual_goal.hidden_size=32",
    "model.language_goal.hidden_size=32", "model.action_decoder.hidden_size=32",
    "model.language_encoder.width=32", "model.language_encoder.heads=2",
]
SMALL_BATCH = ["datamodule.batch_size_vis=2", "datamodule.batch_size_lang=2",
               "datamodule.min_window_size=4", "datamodule.max_window_size=4"]
WARMUP = {"kind": "linear_warmup", "num_warmup_steps": 4, "num_training_steps": 10}


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _run(device="cpu", batch=SMALL_BATCH) -> SyntheticRun:
    return SyntheticRun(flagship_config(TINY + list(batch)), device)


def _graph_counts() -> dict:
    counters = trace.drain()["counters"]
    return {k: counters.get(k, 0) for k in ("train.eager_steps", "train.graph_captures",
                                             "train.graph_replays")}


# ---- on the CPU --------------------------------------------------------------- #
@pytest.mark.parametrize("device,world,draws,wrapped,engages", [
    ("cuda", 1, None, False, True), ("cpu", 1, None, False, False), ("cuda", 1, {}, False, False),
    ("cuda", 2, None, True, False), ("cuda", 4, None, True, False),
    ("cuda", 1, None, True, False)])
def test_graph_engages_on_one_card_without_draws(device, world, draws, wrapped, engages):
    assert steps.graph_engages(torch.device(device), world, draws, wrapped) is engages


def test_cpu_steps_stay_eager_and_say_so():
    torch.set_num_threads(1)
    run = _run()
    trace.enable()
    run.step(run.next_batch())
    run.step(run.next_batch())
    run.train_step(run.next_batch(), run.generator, run.kl_beta, draws={})
    assert _graph_counts() == {"train.eager_steps": 3, "train.graph_captures": 0,
                               "train.graph_replays": 0}


def _tensor_run(lr_tensor: bool, seed_steps: int = 3):
    """Three CPU steps of the tiny flagship under a warm-up schedule, its
    learning rate a float or a float64 tensor that the schedule fills, and
    the KL beta a float or a float32 scalar: (losses, parameters, lrs)."""
    torch.set_num_threads(1)
    cfg = flagship_config(TINY + SMALL_BATCH)
    run = SyntheticRun(cfg, "cpu")
    lr = cfg["model"]["optimizer"]["lr"]
    opt = torch.optim.Adam(run.model.parameters(), betas=(0.9, 0.999), eps=1e-8,
                           lr=torch.tensor(lr, dtype=torch.float64) if lr_tensor else lr)
    sched = optim.make_scheduler(opt, cfg["model"]["optimizer"], WARMUP)
    dm = cfg["datamodule"]
    transform = make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                     dm["transforms"], dtype=torch.float32)
    step = steps.make_train_step(run.model, opt, transform, cfg["loss"]["clip_auxiliary_loss_beta"],
                                 steps.aux_betas_from_loss_cfg(cfg["loss"]), device="cpu",
                                 scheduler=sched)
    kl = torch.tensor(run.kl_beta, dtype=torch.float32) if lr_tensor else run.kl_beta
    losses, lrs = [], []
    for k in range(seed_steps):
        run.generator.manual_seed(100 + k)
        lrs.append(float(opt.param_groups[0]["lr"]))  # the update's
        losses.append(step(run.next_batch(), run.generator, kl)["loss"])
    assert isinstance(opt.param_groups[0]["lr"], torch.Tensor) is lr_tensor
    return losses, [p.detach().clone() for p in run.model.parameters()], lrs


def test_device_scalar_kl_beta_and_tensor_lr_give_the_floats_steps():
    floats, tensors = _tensor_run(False), _tensor_run(True)
    assert floats[2] == tensors[2] and floats[2][0] == 0.0 < floats[2][1]  # the warm-up's
    for a, b in zip(floats[0], tensors[0]):
        assert torch.equal(a, b)
    for a, b in zip(floats[1], tensors[1]):
        assert torch.equal(a, b)


def test_make_optimizer_is_capturable_only_on_the_card():
    params = [torch.nn.Parameter(torch.ones(3))]
    for cfg in ({"kind": "adam", "lr": 1e-3}, {"kind": "adamw", "lr": 1e-3}):
        opt = optim.make_optimizer(params, cfg)
        assert opt.param_groups[0]["capturable"] is False and not opt.param_groups[0]["fused"]
        assert opt.param_groups[0]["lr"] == 1e-3 and not steps.capture_safe(opt)
    sgd = optim.make_optimizer(params, {"kind": "sgd", "lr": 1e-3})
    assert "capturable" not in sgd.param_groups[0] and not steps.capture_safe(sgd)


def test_a_loaded_state_dict_takes_the_built_settings():
    """``make_optimizer``'s load hook on the card, here on the CPU's device:
    each group fused and capturable, its lr a float32 scalar; the caller's
    state dict is not changed."""
    state = {"state": {}, "param_groups": [{"lr": 5e-4, "fused": None, "capturable": False,
                                            "params": [0]},
                                           {"lr": torch.tensor(1e-3, dtype=torch.float64),
                                            "fused": False, "capturable": False, "params": [1]}]}
    built = optim._as_built(state, torch.device("cpu"))
    for group, lr in zip(built["param_groups"], (5e-4, 1e-3)):
        assert group["fused"] is True and group["capturable"] is True
        assert group["lr"].dtype == torch.float32 and group["lr"].item() == pytest.approx(lr)
    assert state["param_groups"][0]["lr"] == 5e-4 and state["param_groups"][1]["fused"] is False
    assert built["param_groups"][0]["params"] == [0]


def test_signature_changes_with_shape_dtype_and_gumbel():
    def batch(rows, dtype=torch.float32):
        return {"vis": {"actions": torch.zeros(rows, 4, 7, dtype=dtype)},
                "lang": {"actions": torch.zeros(2, 4, 7),
                         "lang": torch.zeros(2, 77, dtype=torch.int32)}}

    base = steps.batch_signature(batch(2), None)
    assert base == steps.batch_signature(batch(2), None)
    assert base != steps.batch_signature(batch(3), None)
    assert base != steps.batch_signature(batch(2, torch.float64), None)
    gumbel = steps.batch_signature(batch(2), torch.zeros(4, 32, 32))
    assert gumbel != base and gumbel == steps.batch_signature(batch(2), torch.ones(4, 32, 32))
    assert gumbel != steps.batch_signature(batch(2), torch.zeros(4, 16, 32))
    assert [leaf[0] for leaf in base[0]] == [("vis", "actions"), ("lang", "actions"),
                                             ("lang", "lang")]
    assert steps.batch_signature({"x": 3}, None)[0] == ((("x",), None, None, None),)


# ---- on the card -------------------------------------------------------------- #
def _gumbel(run: SyntheticRun, k: int) -> torch.Tensor:
    d = run.model.dist
    rows = run.data.batch_vis + run.data.batch_lang
    g = torch.Generator().manual_seed(1000 + k)
    u = torch.rand((rows, d.category_size, d.class_size), generator=g).clamp(1e-6, 1 - 1e-6)
    return (-torch.log(-torch.log(u))).to(run.device)


def _steps(run: SyntheticRun, n: int, eager: bool, gumbel: bool = False, kl_betas=None):
    """``n`` steps of ``run``, each reseeded, eager ones with ``eager=True``;
    the losses and the parameters after."""
    losses = []
    for k in range(n):
        raw = run.next_batch()
        run.generator.manual_seed(7 + k)
        out = run.train_step(raw, run.generator, run.kl_beta if kl_betas is None else kl_betas[k],
                             gumbel=_gumbel(run, k) if gumbel else None,
                             eager=eager)
        losses.append(out["loss"].item())
    return losses, [p.detach().clone() for p in run.model.parameters()]


def _gaps(a, b, start):
    """The largest relative loss gap and the largest parameter gap over the
    parameter's change from ``start``."""
    loss = max(abs(x - y) / abs(x) for x, y in zip(a[0], b[0]))
    update = max(((p - q).norm() / (p - s).norm().clamp_min(1e-12)).item()
                 for p, q, s in zip(a[1], b[1], start))
    return loss, update


def _compare(cuda_device, **kw):
    runs = [_run("cuda") for _ in range(3)]
    start = [p.detach().clone() for p in runs[0].model.parameters()]
    for r in runs[1:]:
        r.model.load_state_dict(runs[0].model.state_dict())
    trace.enable()
    eager_a = _steps(runs[0], 5, eager=True, **kw)
    eager_b = _steps(runs[1], 5, eager=True, **kw)
    drained = trace.drain()["counters"]
    assert drained.get("train.graph_replays", 0) == 0
    graph = _steps(runs[2], 5, eager=False, **kw)
    counts = _graph_counts()
    assert counts == {"train.eager_steps": 1, "train.graph_captures": 1, "train.graph_replays": 3}
    noise = _gaps(eager_a, eager_b, start)
    gap = _gaps(eager_a, graph, start)
    print(f"[graph] {kw}: eager vs eager loss {noise[0]:.3g}, update {noise[1]:.3g}; "
          f"eager vs replay loss {gap[0]:.3g}, update {gap[1]:.3g}")
    return noise, gap


@pytest.mark.cuda
@pytest.mark.parametrize("gumbel", [False, True])
def test_replays_match_the_eager_step(cuda_device, gumbel):
    noise, gap = _compare(cuda_device, gumbel=gumbel)
    assert gap[0] <= 2 * noise[0] and gap[1] <= 2 * noise[1]


def _own_step(run: SyntheticRun, wrap=None) -> torch.optim.Optimizer:
    """Give ``run`` a train step of its own: Adam at 1e-3 under the warm-up
    schedule, the tiny flagship's bf16 transform (``wrap(transform)`` in
    its place when given); returns the optimizer."""
    opt_cfg = {"kind": "adam", "lr": 1e-3}
    opt = optim.make_optimizer(run.model.parameters(), opt_cfg)
    cfg = flagship_config(TINY + SMALL_BATCH)
    dm = cfg["datamodule"]
    transform = make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                     dm["transforms"], dtype=torch.bfloat16)
    run.train_step = steps.make_train_step(
        run.model, opt, transform if wrap is None else wrap(transform),
        cfg["loss"]["clip_auxiliary_loss_beta"], steps.aux_betas_from_loss_cfg(cfg["loss"]),
        device="cuda", scheduler=optim.make_scheduler(opt, opt_cfg, WARMUP))
    return opt


@pytest.mark.cuda
def test_kl_beta_and_the_schedule_reach_the_replay(cuda_device):
    """A KL beta that changes every step and a warm-up schedule: a replay
    that read the captured values would drift from the eager steps."""
    runs = [_run("cuda") for _ in range(2)]
    runs[1].model.load_state_dict(runs[0].model.state_dict())
    start = [p.detach().clone() for p in runs[0].model.parameters()]
    out = []
    for run in runs:
        opt = _own_step(run)
        assert steps.capture_safe(opt)
        out.append(_steps(run, 6, eager=run is runs[0],
                          kl_betas=[0.01 * (k + 1) for k in range(6)]))
        lr = opt.param_groups[0]["lr"]
        assert isinstance(lr, torch.Tensor) and lr.item() == pytest.approx(1e-3)
    # the eager steps' own spread is the rounding of two runs (test above)
    loss_gap, update_gap = _gaps(out[0], out[1], start)
    print(f"[graph] changing kl_beta and warm-up lr: loss {loss_gap:.3g}, update {update_gap:.3g}")
    assert loss_gap < 1e-3 and update_gap < 1e-2


@pytest.mark.cuda
def test_a_step_that_syncs_on_its_first_call_stays_eager(cuda_device):
    """A signature whose first call synchronises is never captured."""
    calls = 0

    def wrap(transform):
        def syncing_transform(raw, generator, draws=None):
            nonlocal calls
            calls += 1
            if calls == 1:
                raw["actions"].sum().item()  # a host synchronisation
            return transform(raw, generator, draws)
        return syncing_transform

    run = _run("cuda")
    _own_step(run, wrap)
    trace.enable()
    _steps(run, 5, eager=False)
    assert _graph_counts() == {"train.eager_steps": 5, "train.graph_captures": 0,
                               "train.graph_replays": 0}


@pytest.mark.cuda
def test_returned_metrics_outlive_the_next_replay(cuda_device):
    run = _run("cuda")
    got = [run.step(run.next_batch()) for _ in range(4)]  # eager, capture, replay, replay
    values = [{k: v.item() for k, v in m.items()} for m in got]
    run.step(run.next_batch())
    torch.cuda.synchronize()
    for m, v in zip(got, values):
        assert {k: t.item() for k, t in m.items()} == v
    ptrs = [m["loss"].untyped_storage().data_ptr() for m in got[1:]]
    assert len(set(ptrs)) == len(ptrs)
    assert values[2]["loss"] != values[3]["loss"]  # two batches, two steps


@pytest.mark.cuda
def test_counters_over_two_signatures(cuda_device):
    """8 steps, 4 of one batch shape and 4 of another: each signature's
    first call eager, its second a capture, the rest replays; the wrapper
    counts the eager and the captured launches, the replays count theirs
    apart."""
    from hulc2_torch import kernels

    run = _run("cuda")
    wide = _run("cuda", ["datamodule.batch_size_vis=3", "datamodule.batch_size_lang=3",
                         "datamodule.min_window_size=4", "datamodule.max_window_size=4"])
    kernels.reset_launch_counts()
    trace.enable()
    for data in (run, wide):
        for _ in range(4):
            run.step(data.next_batch())
    counters = trace.drain()["counters"]
    assert {k: counters.get(k, 0) for k in ("train.eager_steps", "train.graph_captures",
                                             "train.graph_replays")} == {
        "train.eager_steps": 2, "train.graph_captures": 2, "train.graph_replays": 4}
    assert counters["train.host_syncs"] == 0
    assert kernels.LAUNCHES["shift_normalize"] == 2 * 4  # 2 eager steps, 2 captures
    assert kernels.REPLAYED["shift_normalize"] == 2 * 4
    assert kernels.launch_counts()["shift_normalize"] == 2 * 8
    graphs = [v for v in run.train_step.graphs.table.values()
              if isinstance(v, steps.CapturedStep)]
    assert len(graphs) == 2
    print(f"[graph] counters {counters}")


@pytest.mark.cuda
def test_replayed_steps_run_the_kernel_on_the_device_trace(cuda_device):
    """Two replayed steps under the profiler: the device trace holds each
    step's two shift_normalize launches (one per camera), which only the
    replay counter counts on the host."""
    from hulc2_torch import kernels
    from hulc2_torch.tools.profiling import profile_steps

    run = _run("cuda")
    run.step(run.next_batch())
    run.step(run.next_batch())  # the capture
    kernels.reset_launch_counts()
    _, _, activities, _ = profile_steps(run, 2)
    assert sum("shift_normalize" in e.name for e in activities) == 2 * 2
    assert kernels.LAUNCHES["shift_normalize"] == 0
    assert kernels.REPLAYED["shift_normalize"] == 2 * 2


@pytest.mark.cuda
def test_memory_peak_stays_near_the_eager_peak(cuda_device):
    full = ["datamodule.batch_size_vis=8", "datamodule.batch_size_lang=8",
            "datamodule.min_window_size=16", "datamodule.max_window_size=16"]
    peaks, pool = {}, 0
    for eager in (True, False):
        run = _run("cuda", full)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in range(20):
            run.step(run.next_batch(), eager=eager)
            if k == 0:  # the capture gives the cache's unused blocks back first
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
            if k == 1 and not eager:  # the capture: its pool is what it reserved
                pool = torch.cuda.memory_reserved() - reserved
        torch.cuda.synchronize()
        peaks[eager] = torch.cuda.max_memory_allocated()
        del run
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[graph] peak eager {peaks[True]}, graph {peaks[False]}, pool {pool}")
    assert peaks[False] <= 1.3 * peaks[True] + pool


@pytest.mark.cuda
def test_make_optimizer_on_the_card_stays_as_built_through_a_load(cuda_device):
    params = [torch.nn.Parameter(torch.ones(3, device=cuda_device))]
    params[0].grad = torch.ones_like(params[0])
    opt = optim.make_optimizer(params, {"kind": "adamw", "lr": 1e-3, "weight_decay": 0.01})
    group = opt.param_groups[0]
    assert group["fused"] is True and group["capturable"] is True and group["lr"].is_cuda
    assert steps.capture_safe(opt)
    # a checkpoint of an eager optimizer: a float lr, neither fused nor capturable
    eager = torch.optim.AdamW(params, lr=5e-4, weight_decay=0.01)
    eager.step()
    state = eager.state_dict()
    opt.load_state_dict(state)
    group = opt.param_groups[0]
    lr = group["lr"]
    assert isinstance(lr, torch.Tensor) and lr.is_cuda and lr.item() == pytest.approx(5e-4)
    assert group["fused"] is True and steps.capture_safe(opt)
    assert state["param_groups"][0]["lr"] == 5e-4  # the caller's state dict is left as it was
    assert opt.state[params[0]]["step"].is_cuda
    opt.step()


@pytest.mark.cuda
def test_given_draws_a_tensor_kl_and_eager_stay_eager_on_the_card(cuda_device):
    run = _run("cuda")
    trace.enable()
    for _ in range(3):
        run.train_step(run.next_batch(), run.generator, run.kl_beta, draws={})
    for _ in range(3):
        run.train_step(run.next_batch(), run.generator, torch.tensor(0.01, device=cuda_device))
    for _ in range(3):
        run.step(run.next_batch(), eager=True)
    assert _graph_counts() == {"train.eager_steps": 9, "train.graph_captures": 0,
                               "train.graph_replays": 0}
