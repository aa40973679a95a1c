"""Data-parallel training of the port on the CPU: spawned gloo processes
against one process over the same global batch.

Port only: the one-process step is held to JAX by ``test_torch_port_trainer.py``
and ``test_torch_port_policy_options.py``. The small flagship here keeps the
posterior's dropout on and adds every batch-coupled loss (the CLIP loss, the
task CE, BC-Z and MIA, whose negatives roll over the batch), with aux masks
and task ids that differ between the ranks' rows, so that the global draws,
the gathers and the global denominators are all tested. The per-process
loader shards are held to the JAX package's loaders.
"""
from __future__ import annotations

import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.data.device_transforms import camera_sizes, make_batch_transform
from hulc2_torch.models.build import build_policy_for
from hulc2_torch.train.optim import make_optimizer
from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step

WORLD = 2
STEPS = 2
RTOL = 1e-5
# narrow widths, flagship structure, the posterior's dropout on, every
# batch-coupled aux loss, 4 + 4 global windows of 4 frames
DP_OVERRIDES = (
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.plan_recognition.dropout_p=0.1",
    "model.distribution.category_size=4", "model.distribution.class_size=5",
    "model.visual_goal.hidden_size=32", "model.visual_goal.latent_goal_features=8",
    "model.language_goal.hidden_size=32", "model.language_goal.latent_goal_features=8",
    "model.language_encoder.width=32", "model.language_encoder.heads=2",
    "model.language_encoder.output_dim=24", "model.action_decoder.hidden_size=32",
    "model.proj_vis_lang.output_dim=16", "model.lang_task_classes=6",
    'model.compute_dtype="float32"', "model.use_bc_z_auxiliary_loss=true",
    "model.use_mia_auxiliary_loss=true", "model.use_state_recons=true",
    "datamodule.batch_size_vis=4", "datamodule.batch_size_lang=4",
    "datamodule.max_window_size=4",
)


# the parameters are compared after SGD steps: Adam moves an element whose
# gradient is zero (a key projection's bias) by lr x its rounding noise, in
# both runs alike, and a large lr makes a wrong gradient show
SGD = ("model/optimizer=sgd", "model.optimizer.lr=0.05")


def dp_config(*extra: str) -> dict:
    return flagship_config(DP_OVERRIDES + extra)


def global_batch(cfg: dict, seed: int = 0) -> dict:
    """{"vis": ..., "lang": ...} tensors of the global batch. Rank 0's lang
    rows (0, 1) hold both aux rows and valid task ids; rank 1's hold one aux
    row and one task id of -1."""
    rng = np.random.default_rng(seed)
    dm = cfg["datamodule"]
    s, sizes = dm["max_window_size"], camera_sizes(dm["transforms"])

    def window(b):
        actions = np.clip(rng.standard_normal((b, s, 7)) * 0.3, -1, 1).astype(np.float32)
        actions[..., -1] = np.sign(actions[..., -1] + 1e-6)
        return {"rgb_static": rng.integers(0, 256, (b, s, sizes["rgb_static"],
                                                    sizes["rgb_static"], 3), dtype=np.uint8),
                "rgb_gripper": rng.integers(0, 256, (b, s, sizes["rgb_gripper"],
                                                     sizes["rgb_gripper"], 3), dtype=np.uint8),
                "robot_obs_raw": rng.standard_normal((b, s, 15)).astype(np.float32),
                "actions": actions}

    b = dm["batch_size_lang"]
    lang = window(b)
    toks = np.zeros((b, 77), np.int64)
    for i in range(b):
        n = int(rng.integers(4, 12))
        toks[i, 0], toks[i, n - 1] = 49406, 49407
        toks[i, 1:n - 1] = rng.integers(1, 49000, n - 2)
    lang["lang"] = toks
    lang["use_for_aux_lang_loss"] = np.array([True, True, True, False])
    lang["lang_task_id"] = np.array([2, 5, 1, -1], np.int32)
    batch = {"vis": window(dm["batch_size_vis"]), "lang": lang}
    return {m: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in w.items()}
            for m, w in batch.items()}


def rank_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous share of each modality's rows."""
    out = {}
    for m, w in batch.items():
        n = w["actions"].shape[0] // world
        out[m] = {k: v[rank * n:(rank + 1) * n] for k, v in w.items()}
    return out


def run_steps(cfg: dict, model, batches, steps: int = STEPS) -> tuple:
    """``steps`` train steps on ``batches`` (one per step, or one for all),
    each step's generator seeded from its index; (metrics per step, the
    policy's parameters after)."""
    from hulc2_torch.parallel.mesh import unwrap

    core = unwrap(model)
    optimizer = make_optimizer(model.parameters(), cfg["model"]["optimizer"])
    dm = cfg["datamodule"]
    transform = make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                     dm["transforms"], dtype=torch.float32)
    step = make_train_step(model, optimizer, transform, cfg["loss"]["clip_auxiliary_loss_beta"],
                           aux_betas_from_loss_cfg(cfg["loss"]), device="cpu")
    generator = torch.Generator()
    history = []
    for k in range(steps):
        generator.manual_seed(1000 + k)
        metrics = step(batches, generator, cfg["loss"]["kl_beta"])
        history.append({name: float(v) for name, v in metrics.items()})
    params = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().clone()
              for n, p in core.named_parameters()}
    return history, params


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from hulc2_torch.parallel.mesh import make_mesh, wrap_model
    from hulc2_torch.train.callbacks import allgather_counts

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        cfg, sgd = dp_config(), dp_config(*SGD)
        local = rank_rows(global_batch(cfg), rank, world)
        mesh = make_mesh()
        history, _ = run_steps(cfg, wrap_model(build_policy_for(cfg, seed=0), mesh), local)
        _, params = run_steps(sgd, wrap_model(build_policy_for(sgd, seed=0), mesh), local)
        fsdp = wrap_model(build_policy_for(sgd, seed=0), make_mesh(dp=1, fsdp=world))
        fsdp_history, fsdp_params = run_steps(sgd, fsdp, local, steps=1)
        counts = allgather_counts(np.array([rank + 1, 10 * rank], np.int64))
        if rank == 0:
            torch.save({"history": history, "params": params, "fsdp_history": fsdp_history,
                        "fsdp_params": fsdp_params, "counts": counts},
                       os.path.join(out_dir, "ranks.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Two gloo ranks' DDP metrics over ``STEPS`` Adam steps and parameters
    after ``STEPS`` SGD steps, their FSDP (fsdp 2) SGD step, and one
    process's on the global batch."""
    out = tmp_path_factory.mktemp("dp")
    mp.spawn(_worker, args=(WORLD, _free_port(), str(out)), nprocs=WORLD, join=True)
    ranks = torch.load(out / "ranks.pt", weights_only=False)
    cfg, sgd = dp_config(), dp_config(*SGD)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        batch = global_batch(cfg)
        ref_history, _ = run_steps(cfg, build_policy_for(cfg, seed=0), batch)
        _, ref_params = run_steps(sgd, build_policy_for(sgd, seed=0), batch)
        ref_sgd_history, ref_params_1 = run_steps(sgd, build_policy_for(sgd, seed=0), batch,
                                                  steps=1)
    finally:
        torch.set_num_threads(threads)
    return ranks, ref_history, ref_params, (ref_sgd_history, ref_params_1)


def _close(got: float, want: float, rtol: float = RTOL) -> bool:
    return abs(got - want) <= rtol * max(abs(want), 1e-6)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest elementwise error over the tensor's largest magnitude."""
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-6)).item()


@pytest.mark.parametrize("step", range(STEPS))
def test_two_ranks_equal_one_process_on_every_loss_term(spawned, step):
    ranks, ref_history, _, _ = spawned
    got, want = ranks["history"][step], ref_history[step]
    assert set(got) == set(want)
    for key in ("lang_clip_loss", "lang_task_loss", "lang_task_acc", "lang_pred_loss",
                "lang_contrastive_loss", "proprio_loss", "grad_norm", "loss"):
        assert key in want
    bad = {k: (got[k], want[k]) for k in want if not _close(got[k], want[k])}
    assert not bad, bad


def test_two_ranks_equal_one_process_parameters(spawned):
    ranks, _, ref_params, _ = spawned
    errs = {name: _rel(ranks["params"][name], want) for name, want in ref_params.items()}
    assert max(errs.values()) <= RTOL, max(errs.items(), key=lambda kv: kv[1])


def test_fsdp_step_equals_ddp_step(spawned):
    """FSDP2 over a (1, 2) mesh after one step equals one process (and so
    DDP) after one step; the JAX rule shards the 2^20-element matrices on
    their largest axis."""
    ranks, _, _, (ref_history, ref_params_1) = spawned
    assert all(_close(ranks["fsdp_history"][0][k], v) for k, v in ref_history[0].items())
    errs = {name: _rel(ranks["fsdp_params"][name], want) for name, want in ref_params_1.items()}
    assert max(errs.values()) <= RTOL, max(errs.items(), key=lambda kv: kv[1])


def test_allgather_counts_sums_over_ranks(spawned):
    assert spawned[0]["counts"].tolist() == [3, 10]


# ---- the per-process loader shards against the JAX package's --------------- #
@pytest.fixture(scope="module")
def calvin_dir(tmp_path_factory):
    from _torch_port_dataset import write_calvin_dir

    return write_calvin_dir(tmp_path_factory.mktemp("calvin_dp"))


def _both_datamodules(root, device_store: bool, rank: int):
    from _torch_port_dataset import dm_cfg
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_tpu.data.datamodule import Hulc2DataModule as JaxDataModule

    cfg = dm_cfg(root, batch_vis=2, batch_lang=2, min_window=4, max_window=6)
    cfg["device_store"] = device_store
    cfg["num_workers"] = 1
    dm = Hulc2DataModule(cfg, seed=5, device="cpu", process_index=rank, process_count=WORLD)
    jdm = JaxDataModule(cfg, seed=5, process_index=rank, process_count=WORLD)
    dm.setup()
    jdm.setup()
    return dm, jdm


@pytest.mark.parametrize("device_store", [False, True], ids=["host", "store"])
@pytest.mark.parametrize("rank", range(WORLD))
def test_process_shards_equal_jax_loaders(calvin_dir, device_store, rank):
    """Each process's fused training batches over two epochs (the host
    ``FusedBatchLoader`` and the device-store gather, here on the CPU) and
    its validation batches (``BatchLoader``) equal the JAX package's for the
    same process index; an epoch is half as long as one process's."""
    dm, jdm = _both_datamodules(calvin_dir, device_store, rank)
    loader, ref = dm.fused_train_iter(), jdm.fused_train_iter()
    one = len(dm.datasets["vis_training"]) // 2
    assert len(loader) == len(ref) == dm.steps_per_epoch() == min(
        one // WORLD, len(dm.datasets["lang_training"]) // 2 // WORLD) > 0
    for epoch in range(2):
        n = 0
        for got, want in zip(loader, ref):
            for k, w in want.items():
                g = got[k].cpu().numpy() if torch.is_tensor(got[k]) else got[k]
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"epoch {epoch} {k}")
            n += 1
        assert n == len(ref)
    n = 0
    for got, want in zip(dm.val_iter(), jdm.val_iter()):
        for m in want:
            for k, w in want[m].items():
                np.testing.assert_array_equal(got[m][k], w, err_msg=f"val {m} {k}")
        n += 1
    assert n == dm.val_batches() > 0


# ---- JAX's multi-process batch layout -------------------------------------- #
def test_jax_multiprocess_layout_pairs_the_wrong_rows(monkeypatch):
    """Each JAX process fuses its [vis_p; lang_p] rows on its host
    (``hulc2_tpu/data/loader.py:341-357``) and ``make_array_from_process_local_data``
    stacks the processes' rows (``:263-283``): the step sees [vis0; lang0;
    vis1; lang1] and splits it at actions rows - lang rows
    (``hulc2_tpu/train/steps.py:47``). Rows of process 0's lang windows
    become visual goals and process 1's vis frames are paired with the lang
    embeddings, so the terms that see the pairing differ from those of the
    global batch [vis0; vis1; lang0; lang1], which the port's ranks train on
    (the spawned tests above) and which equals the port's one-process step.
    The task CE reads the language alone and does not see it."""
    import jax

    from _torch_port_common import (build_both, fuse, install_gumbel_rsample, jax_batch,
                                    make_raw_batch, small_config, torch_raw)

    cfg = small_config()
    jmodel, params, tmodel = build_both(cfg)
    rng = np.random.default_rng(11)
    r0, r1 = make_raw_batch(rng, cfg), make_raw_batch(rng, cfg)
    rows = 2 * (cfg["datamodule"]["batch_size_vis"] + cfg["datamodule"]["batch_size_lang"])
    n_vis = 2 * cfg["datamodule"]["batch_size_vis"]  # JAX's: action rows - lang rows
    # centred crops and zero Gumbel noise: the layouts differ in row order only
    pads_center = {cam: np.full((rows * cfg["datamodule"]["max_window_size"], 2), pad, np.int32)
                   for cam, pad in PADS_DP.items()}
    lang = {k: np.concatenate([r0["lang"][k], r1["lang"][k]])
            for k in ("lang", "use_for_aux_lang_loss", "lang_task_id")}
    global_raw = {"vis": {k: np.concatenate([r0["vis"][k], r1["vis"][k]]) for k in r0["vis"]},
                  "lang": {**{k: np.concatenate([r0["lang"][k], r1["lang"][k]])
                              for k in r0["vis"]}, **lang}}
    # what the step sees: process 0's fused rows, then process 1's
    jax_layout = {"vis": fuse(r0), "lang": {**fuse(r1), **lang}}
    install_gumbel_rsample(monkeypatch)["g"] = 0.0
    apply = jax.jit(lambda p, b: jmodel.apply(p, b, 0.01, False, n_vis,
                                              rngs={"sample": jax.random.PRNGKey(0)}))

    def metrics(raw):
        return {k: float(v) for k, v in apply(params, jax_batch(raw, pads_center)).items()}

    mixed, right = metrics(jax_layout), metrics(global_raw)
    for key in ("lang_clip_loss", "kl_loss_lang", "action_loss_vis"):
        assert abs(mixed[key] - right[key]) > 1e-4 * max(abs(right[key]), 1e-3), key
    assert abs(mixed["lang_task_loss"] - right["lang_task_loss"]) <= 1e-6
    # the port's one-process step on the global batch is JAX's on it
    from hulc2_torch.data.device_transforms import make_batch_transform as tf_factory

    dm = cfg["datamodule"]
    transform = tf_factory(dm["observation_space"], dm["proprioception_dims"], dm["transforms"],
                           dtype=torch.float32)
    raw_t = torch_raw(global_raw)
    fused = {k: torch.cat([raw_t["vis"][k], raw_t["lang"][k]]) for k in raw_t["vis"]}
    fused.update({k: raw_t["lang"][k] for k in ("lang", "use_for_aux_lang_loss", "lang_task_id")})
    draws = {cam: {1: torch.from_numpy(off)} for cam, off in pads_center.items()}
    b = transform(fused, None, draws)
    d = cfg["model"]["distribution"]
    gumbel = torch.zeros((rows, d["category_size"], d["class_size"]))
    with torch.no_grad():
        got = tmodel(b, 0.01, n_vis, deterministic=True, gumbel=gumbel)
    for key in ("lang_clip_loss", "kl_loss_lang", "action_loss_vis", "lang_task_loss"):
        assert abs(float(got[key]) - right[key]) <= 1e-4 * max(abs(right[key]), 1e-3), key


PADS_DP = {"rgb_static": 4, "rgb_gripper": 3}


def test_torchrun_trains_on_every_rank(calvin_dir, tmp_path):
    """``torchrun --nproc_per_node 2 -m hulc2_torch.training --device cpu``
    over gloo: both ranks train one epoch of their shards with the
    long-horizon callback's chains split between them; the main process
    alone writes the metrics lines and the checkpoint."""
    import subprocess
    import sys
    from pathlib import Path

    from _torch_port_dataset import dm_cfg

    run = tmp_path / "run"
    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo), "OMP_NUM_THREADS": "1",
           "HULC2_SEQUENCES_CACHE_DIR": str(tmp_path)}
    dm = dm_cfg(calvin_dir, batch_vis=2, batch_lang=2, min_window=4, max_window=4)
    dm["num_workers"] = 1
    argv = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(WORLD),
            "--master_port", str(_free_port()), "-m", "hulc2_torch.training", "--device", "cpu",
            "--run-dir", str(run), "--max-epochs", "1", *DP_OVERRIDES[:16],
            f"datamodule.root_data_dir={calvin_dir}", "datamodule.batch_size_vis=2",
            "datamodule.batch_size_lang=2", "datamodule.min_window_size=4",
            "datamodule.max_window_size=4", "datamodule.num_workers=1",
            "model.lang_task_classes=34", "trainer.log_every_n_steps=1",
            "trainer.limit_val_batches=1",
            'callbacks.rollout_lh={"env":"fake","num_sequences":4,"ep_len":2,'
            '"every_n_epochs":1,"start_epoch":0}']
    proc = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=300, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    train = [line for line in lines if "train/loss" in line]
    steps_one_rank = len(train)
    assert steps_one_rank >= 1 and [line["step"] for line in train] == list(
        range(1, steps_one_rank + 1))
    lh = [line for line in lines if "eval_lh/avg_seq_len" in line]
    assert len(lh) == 1 and 0.0 <= lh[0]["eval_lh/avg_seq_len"] <= 5.0
    assert sorted(p.name for p in (run / "saved_models").iterdir()) == [f"{steps_one_rank}.pt"]
    assert all(f"process group: rank {r} of {WORLD} (gloo)" in proc.stderr for r in range(WORLD))
    from hulc2_torch.data.datamodule import Hulc2DataModule

    shard = Hulc2DataModule(dm, process_index=1, process_count=WORLD, device="cpu")
    shard.setup(splits=("training",))
    assert steps_one_rank == shard.steps_per_epoch()


@pytest.mark.parametrize("fsdp", [1, 2, 4])
def test_fsdp_shard_axis_equals_jax_rule(fsdp):
    """``mesh.shard_dim`` names the axis JAX's ``param_sharding_rules`` shards
    over fsdp (2 or more axes, 2^20 elements or more, the largest axis the
    fsdp size divides), or none where JAX replicates."""
    import jax
    from jax.sharding import Mesh

    from hulc2_torch.parallel.mesh import shard_dim
    from hulc2_tpu.parallel.mesh import param_sharding_rules

    mesh = Mesh(np.asarray(jax.devices()[:fsdp]).reshape(1, fsdp), ("dp", "fsdp"))
    shapes = [(2048, 2048), (4096, 256), (256, 4096), (1023, 2048), (2048, 1023),
              (1024, 1024), (1023, 1025), (512, 512), (4096,), (64, 128, 128), (3, 1 << 20)]
    for shape in shapes:
        spec = param_sharding_rules((), jax.ShapeDtypeStruct(shape, np.float32), mesh).spec
        want = next((i for i, axis in enumerate(spec) if axis == "fsdp"), None)
        assert shard_dim(shape, fsdp) == want, (shape, fsdp, spec)
