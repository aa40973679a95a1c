"""Chip smoke test of the PyTorch/CUDA port (``hulc2_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
1. the card: fail without CUDA; print its name and power limit (nvidia-smi);
2. build every kernel of the main path from ``hulc2_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version at the main path's shapes
   (2048 frames of 96x96x3 with pad 4, and of 64x64x3 with pad 3), bit for
   bit, then its device time beside the memory-traffic bound, the plain
   version's and that of a bf16 cast of the same bytes (CUDA events around 50
   back-to-back launches, ``hulc2_torch.tools.bench_shift_normalize``);
4. a small-width policy on the card in fp32 (TF32 off) against the same
   policy on the CPU, same weights, batches and draws: the train-step losses
   must agree;
5. the full-width policy's forward under bf16 autocast against the same
   forward in fp32 on the card: the losses must agree within 5%;
6. the main path: ``python -m hulc2_torch.training --synthetic`` at the full
   flagship width for a few steps, with every kernel launch count reset just
   before and read just after: losses finite, parameters moved, and
   shift_normalize launched exactly twice per step;
7. (a) the kernel at pad 0, the evaluation's val transform with the preset's
   val mean and std, against its plain version on 1, 2, 4, 8 and 32 frames of
   96x96 and 64x64 (1-8 are the evaluations' frames per camera and dispatch),
   fp32 and bf16, bit for bit, and its device time at the eval's 8 frames per
   camera;
8. (b) the device renderer on the card against the same renderer on the CPU,
   32 evaluation initial states with perturbed robot poses: no pixel off by
   more than one, fewer than 1e-4 of them off at all, depth within 1e-5;
9. (c) a small fp32 policy's fused render+policy step through ``Hulc2Agent``,
   card against CPU, same weights and draws, 40 steps across a replan
   boundary with one ``reset_env_slot``: actions within 1e-3;
10. (d) the evaluation path: ``python -m hulc2_torch.evaluation.evaluate_policy
   --synthetic --fake-env --device-render`` over 32 chains with 32 envs in 4
   cohorts at the full flagship width, counts reset just before and read just
   after: 32 results in 0..5, results.json written, shift_normalize launched
   exactly twice per dispatch;
11. (e) the port's generator (``python -m hulc2_torch.tools.make_expert_dataset``)
   writes a small expert dataset at 96/64 px with token annotations;
12. (f) device-store batches on the card, through the prefetcher, against the
   same plan assembled on the host from the RAM cache, bit for bit, over two
   epochs;
13. (g) the disk path: ``python -m hulc2_torch.training`` from that dataset at
   the full flagship width, one epoch of 20 steps and 2 val batches, then the
   same command to a second epoch, which resumes from step 20, counts reset
   before each run: losses and val metrics finite, config.json and both
   checkpoints written, shift_normalize launched exactly 2 x train steps + 4 x
   val steps; then the kernel against its plain version, bit for bit, on the
   first validation batch (1024 frames per camera and modality) with the val
   pipelines' mean and std, fp32 and bf16;
14. (h) ``evaluate_policy --train-dir`` on that run, 8 chains: the loaded
   parameters equal the checkpoint's, results.json written, shift_normalize
   launched exactly twice per dispatch;
15. (i) the affordance detector (``rn18_tokens_pixel``) at full width in fp32,
   card against CPU, same weights: 8 frames of 96x96 resized on the device to
   224 and the token ids of 8 validation sentences; logits, depth mu and
   sigma within 1e-3 of the largest logit's magnitude (at least 1e-3), and
   equal argmax pixels wherever the CPU's top two logits are further apart
   than twice that;
16. (j) label mining: ``python -m hulc2_torch.affordance.dataset_creation``
   on (e)'s dataset must label frames in both splits;
17. (k) ``python -m hulc2_torch.affordance.train_affordance`` on those labels
   at batch 32, ``AFF_STEPS`` steps with a validation and a checkpoint per
   epoch: losses and val metrics finite, the decoder's and the tower's
   parameters moved, the encoder's bit for bit as initialised, config.json
   holding ``depth_norm``, the last step's checkpoint written;
18. (l) the hierarchical eval: ``evaluate_policy --train-dir`` (g)'s run
   ``--aff-train-dir`` (k)'s run, 8 chains, counts reset just before and
   read just after: the loaded detector's parameters equal the checkpoint's,
   results.json written, one affordance prediction per subtask start,
   approaches taken, shift_normalize launched exactly twice per dispatch;
19. (m) the paraphrase protocol: (l) again with ``--paraphrase-eval``: the
   policy's and the detector's goals are each task's held-out sentences;
   results.json written, ``"paraphrase_eval": true`` in the diagnostics, one
   prediction per subtask start, shift_normalize launched twice per dispatch;
20. (n) ``evaluate_policy --all-checkpoints --device-render`` over the disk
   run's two steps, 4 chains each: both in one results.json, "best" the one
   with the higher avg_seq_len, twice per dispatch of each step;
21. (o) ``--single-step --dataset-path`` the dataset of (e): as many jobs as
   ``harness.dataset_singlestep_sequences`` finds in its validation split,
   one subtask and one record each, twice per dispatch;
22. (p) ``interactive.main`` on the disk run with two instructions on a
   StringIO stdin, one from the offline keyword planner, up to 60 steps
   each: one verdict line per instruction, twice per policy step;
23. the kernels line, the card line, and the final JSON line.
"""
from __future__ import annotations

import json
import logging
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

MAIN_STEPS = 10
WARM_STEPS = 2  # steps 0 and 1 carry cuDNN's algorithm search and allocator growth
BUILD = Path(__file__).resolve().parent / "build"
RUN_DIR = BUILD / "chip_smoke_run"
EVAL_DIR = BUILD / "chip_smoke_eval"
EVAL_ENVS, EVAL_COHORTS, EVAL_CHAINS, EVAL_EP_LEN = 32, 4, 32, 360
# the disk path: a dataset of about 1,700 + 220 frames (29 train batches of
# 32 + 32 windows per epoch, 4 val batches), two runs of one epoch each cut
# to DISK_STEPS steps and DISK_VAL val batches, then 8 chains of the trained run
DATA_DIR = BUILD / "chip_smoke_data"
DISK_RUN = BUILD / "chip_smoke_disk"
DATA_EPISODES, DATA_TASKS, DATA_VAL_TASKS = 3, 12, 6
LOADER_BATCHES = 3
DISK_STEPS, DISK_VAL = 20, 2
DISK_ENVS, DISK_COHORTS, DISK_CHAINS = 8, 2, 8
# the affordance phases: labels mined from the disk path's dataset, a
# detector trained on them for AFF_STEPS steps, then the hierarchical eval of
# the disk run with that detector
AFF_DATA = BUILD / "chip_smoke_aff_data"
AFF_RUN = BUILD / "chip_smoke_aff"
HIER_DIR = BUILD / "chip_smoke_hier"
AFF_STEPS = 20
AFF_FRAMES = 8
# the other protocols, on the disk run (and (k)'s detector): the paraphrase
# eval at (l)'s counts, the every-checkpoint sweep over both saved steps with
# SWEEP_CHAINS chains each, the single-step protocol on the dataset's
# validation split, and the interactive entry point with two instructions
PARA_DIR = BUILD / "chip_smoke_para"
SWEEP_DIR = BUILD / "chip_smoke_sweep"
SINGLE_DIR = BUILD / "chip_smoke_single"
SWEEP_ENVS, SWEEP_CHAINS = 4, 4
SINGLE_ENVS = 2
INTERACTIVE_EP_LEN = 60


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    from hulc2_torch.kernels import build

    t0 = time.perf_counter()
    results = build.build()
    print(f"[build] {len(results)} kernel(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, res in results.items():
        print(f"[build] {name}: {res.path.name} nvcc {res.seconds:.1f} s", flush=True)
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}", flush=True)


def phase_kernel_vs_plain(dev: torch.device) -> dict:
    """The kernel against its plain version, bit for bit, at the main path's
    shapes; then device times per launch (``tools/bench_shift_normalize``: 50
    back-to-back launches over 4 input sets between one pair of CUDA events) of
    the kernel, the plain version and a bf16 cast of the same bytes."""
    from hulc2_torch.ops import preprocess
    from hulc2_torch.tools import bench_shift_normalize as bench

    totals = {"ms": 0.0, "plain_ms": 0.0, "cast_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for seed, (cam, (n, hw, pad)) in enumerate(bench.SHAPES.items()):
        sets = bench.make_sets(n, hw, pad, bench.SETS, dev, seed)
        imgs, offsets = sets[0]
        for out_dtype in (torch.float32, torch.bfloat16):
            got = preprocess.random_shift_normalize(imgs, offsets, pad, [0.5], [0.5], out_dtype)
            want = preprocess.shift_normalize_plain(imgs, offsets, pad, [0.5], [0.5], out_dtype)
            torch.cuda.synchronize(dev)
            if not torch.isfinite(got.float()).all():
                fail(f"shift_normalize {cam} {out_dtype}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            # tolerance 0: the kernel rounds the multiply, the add and the bf16
            # cast exactly as the plain version does
            print(f"[kernel] shift_normalize {cam} {n}x{hw}x{hw}x3 pad {pad} {out_dtype}: "
                  f"max_abs_err {err:.3g} (tol 0)", flush=True)
            if err > 0 or got.shape != want.shape:
                fail(f"shift_normalize disagrees with its plain version on {cam} {out_dtype}")
            totals["max_abs_err"] = max(totals["max_abs_err"], err)
        ms = bench.device_ms(bench.rotating(bench.kernel_fn(pad), sets))
        plain_ms = bench.device_ms(bench.rotating(bench.plain_fn(pad), sets))
        cast_ms = bench.device_ms(bench.rotating(bench.cast_fn, sets))
        bound_ms, bound_by = bench.bound(n, hw, 2)
        gbytes = 3 * imgs.numel() / 1e9  # uint8 in, bf16 out
        print(f"[kernel] shift_normalize {cam} bf16, device time per launch: kernel {ms:.4f} ms "
              f"({gbytes / ms:.3f} TB/s), bound {bound_ms:.4f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}% of roofline); plain version {plain_ms:.4f} ms (same "
              f"arithmetic, unfused); PyTorch's bf16 cast of the same bytes {cast_ms:.4f} ms "
              f"({gbytes / cast_ms:.3f} TB/s)", flush=True)
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["cast_ms"] += cast_ms
        totals["bound_ms"] += bound_ms
        del sets, imgs, offsets, got, want
    return {"bound_by": bound_by, **totals}


SMALL_OVERRIDES = [
    "model.plan_proposal.hidden_size=64", "model.plan_recognition.encoder_hidden_size=64",
    "model.plan_recognition.fc_hidden_size=64", "model.plan_recognition.dropout_p=0.0",
    "model.visual_goal.hidden_size=64", "model.language_goal.hidden_size=64",
    "model.action_decoder.hidden_size=64", "model.language_encoder.width=32",
    "model.language_encoder.heads=2", "model.compute_dtype=\"float32\"",
    "datamodule.batch_size_vis=2", "datamodule.batch_size_lang=2",
    "datamodule.max_window_size=4",
]


def phase_reference(dev: torch.device) -> None:
    """Two fp32 train steps of a small policy on the card and on the CPU, same
    weights, batches and draws; the card runs the kernel, the CPU its plain
    version."""
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.data.device_transforms import make_batch_transform
    from hulc2_torch.data.random_data import RandomWindowBatches
    from hulc2_torch.models.build import build_policy
    from hulc2_torch.train.optim import make_optimizer
    from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    cfg = flagship_config(SMALL_OVERRIDES)
    dm, mc = cfg["datamodule"], cfg["model"]
    data = RandomWindowBatches(2, 2, 4, seed=3, device="cpu")
    batches = [data.next_batch() for _ in range(2)]
    draws = []
    g = torch.Generator().manual_seed(4)
    for _ in batches:
        offsets = {cam: torch.randint(0, 2 * pad + 1, (16, 2), generator=g, dtype=torch.int32)
                   for cam, pad in (("rgb_static", 4), ("rgb_gripper", 3))}
        draws.append((offsets, -torch.log(-torch.log(torch.rand((4, 32, 32), generator=g)))))
    losses = {}
    for device in (torch.device("cpu"), dev):
        model = build_policy(mc, seed=5).to(device)
        opt = make_optimizer(model.parameters(), mc["optimizer"])
        tf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"], dm["transforms"])
        step = make_train_step(model, opt, tf, 3.0, aux_betas_from_loss_cfg(cfg["loss"]), device=device)
        losses[device.type] = []
        for raw, (offsets, gumbel) in zip(batches, draws):
            raw_d = {m: {k: v.to(device) for k, v in w.items()} for m, w in raw.items()}
            off_d = {k: v.to(device) for k, v in offsets.items()}
            metrics = step(raw_d, None, 0.01, off_d, gumbel.to(device))
            losses[device.type].append(metrics["loss"].item())
    print(f"[reference] small fp32 policy, 2 train steps: cpu {losses['cpu']} cuda {losses['cuda']}",
          flush=True)
    for a, b in zip(losses["cpu"], losses["cuda"]):
        # fp32 on both sides, reduction orders differ; Adam's first update can
        # amplify near-zero gradients, so the second step gets a looser bound
        if not math.isclose(a, b, rel_tol=1e-3, abs_tol=1e-4):
            fail(f"card and CPU train-step losses disagree: {losses}")


def phase_bf16_vs_fp32(dev: torch.device) -> float:
    """One forward of the full-width policy on one synthetic batch under bf16
    autocast (bf16 kernel output) and in fp32 (fp32 kernel output), same
    weights, offsets and Gumbel draws: the bf16 losses must stay within 5% of
    the fp32 ones. Returns the largest relative gap."""
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.data.device_transforms import draw_offsets, make_batch_transform
    from hulc2_torch.data.random_data import RandomWindowBatches
    from hulc2_torch.models.build import build_policy

    cfg = flagship_config()
    dm, mc = cfg["datamodule"], cfg["model"]
    model = build_policy(mc, seed=7).to(dev)
    raw = RandomWindowBatches(dm["batch_size_vis"], dm["batch_size_lang"], dm["max_window_size"],
                              seed=8, device=dev).next_batch()
    n_vis = dm["batch_size_vis"]
    fused = {k: torch.cat([raw["vis"][k], raw["lang"][k]]) for k in raw["vis"]}
    n_frames = fused["actions"].shape[0] * fused["actions"].shape[1]
    g = torch.Generator(device=dev).manual_seed(9)
    offsets = {cam: draw_offsets(n_frames, pad, g, dev)
               for cam, pad in (("rgb_static", 4), ("rgb_gripper", 3))}
    gumbel = model.dist.gumbel((fused["actions"].shape[0], model.dist.category_size,
                                model.dist.class_size), g, dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                  dm["transforms"], dtype=dtype)
        batch = tf(fused, None, offsets)
        batch.update({k: raw["lang"][k] for k in ("lang", "use_for_aux_lang_loss", "lang_task_id")})
        with torch.no_grad(), torch.autocast(device_type=dev.type, dtype=torch.bfloat16,
                                             enabled=dtype == torch.bfloat16):
            out[dtype] = model(batch, cfg["loss"]["kl_beta"], n_vis, deterministic=True,
                               gumbel=gumbel)
    worst = 0.0
    for k, ref in out[torch.float32].items():
        if k == "lang_task_acc":
            continue
        a, b = ref.item(), out[torch.bfloat16][k].item()
        gap = abs(a - b) / max(abs(a), 1e-3)
        print(f"[bf16] {k}: fp32 {a:.5f} bf16 {b:.5f} rel gap {gap:.2e}", flush=True)
        if not math.isfinite(b) or gap > 0.05:
            fail(f"bf16 forward drifts from fp32 on {k}: {a} vs {b}")
        worst = max(worst, gap)
    return worst


def phase_main_path(dev: torch.device, card: str) -> dict:
    from hulc2_torch import kernels, training
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.models.build import build_policy

    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    result = training.main(["--synthetic", "--max-steps", str(MAIN_STEPS), "--device", "cuda",
                            "--run-dir", str(RUN_DIR)])
    torch.cuda.synchronize(dev)
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    if len(result.history) != MAIN_STEPS:
        fail(f"expected {MAIN_STEPS} steps, got {len(result.history)}")
    for line in result.history:
        bad = [k for k, v in line.items() if not math.isfinite(v)]
        if bad:
            fail(f"non-finite metrics at step {line['step']}: {bad}")
    if launches["shift_normalize"] != 2 * MAIN_STEPS:
        fail(f"shift_normalize launched {launches['shift_normalize']} times in "
             f"{MAIN_STEPS} steps, expected {2 * MAIN_STEPS}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
    cfg = flagship_config()
    fresh = build_policy(cfg["model"], seed=cfg["seed"]).state_dict()
    trained = result.model.state_dict()
    moved = sum(not torch.equal(fresh[k], trained[k].cpu()) for k in fresh)
    if moved < len(fresh) // 2:
        fail(f"only {moved} of {len(fresh)} parameter tensors changed")
    lines = (RUN_DIR / "metrics.jsonl").read_text().splitlines()
    if len(lines) < MAIN_STEPS:
        fail("metrics.jsonl is short")

    n_params = sum(p.numel() for p in result.model.parameters())
    steady = [line["step_ms"] for line in result.history[WARM_STEPS:]]
    step_ms = statistics.median(steady)
    windows = cfg["datamodule"]["batch_size_vis"] + cfg["datamodule"]["batch_size_lang"]
    frames = windows * cfg["datamodule"]["max_window_size"]
    print(f"[main] flagship policy, {n_params / 1e6:.2f}M params, batch {windows} windows x "
          f"{cfg['datamodule']['max_window_size']} frames, bf16 autocast", flush=True)
    print(f"[main] losses: " + ", ".join(f"{line['loss']:.4f}" for line in result.history), flush=True)
    print(f"[main] {moved}/{len(fresh)} parameter tensors moved; launches {launches}", flush=True)
    print(f"[main] step time {step_ms:.2f} ms (median of steps {WARM_STEPS}..{MAIN_STEPS - 1}, "
          f"spread {min(steady):.1f}-{max(steady):.1f} ms; step 0 "
          f"{result.history[0]['step_ms']:.1f} ms), {1e3 * windows / step_ms:.1f} windows/s = "
          f"{1e3 * frames / step_ms:.0f} frames/s, peak memory {peak_gib:.2f} GiB, on {card}",
          flush=True)
    return launches


def val_norm(cam: str) -> tuple:
    """(mean, std) of the flagship preset's val pipeline for ``cam``."""
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.data.device_transforms import TRANSFORM_PRESETS

    norm = TRANSFORM_PRESETS[flagship_config()["datamodule"]["transforms"]]["val"][cam][-1]
    return norm["mean"], norm["std"]


def check_pad0(tag: str, imgs: torch.Tensor, mean, std) -> float:
    """The kernel at pad 0 with zero offsets against its plain version on
    ``imgs`` (N, H, W, 3) uint8 on the card, fp32 and bf16 out, tolerance 0;
    returns the largest error."""
    from hulc2_torch.ops import preprocess

    offsets = torch.zeros((imgs.shape[0], 2), dtype=torch.int32, device=imgs.device)
    err_max = 0.0
    for out_dtype in (torch.float32, torch.bfloat16):
        got = preprocess.random_shift_normalize(imgs, offsets, 0, mean, std, out_dtype)
        want = preprocess.shift_normalize_plain(imgs, offsets, 0, mean, std, out_dtype)
        torch.cuda.synchronize(imgs.device)
        err = (got.float() - want.float()).abs().max().item()
        print(f"[{tag}] shift_normalize {'x'.join(map(str, imgs.shape))} pad 0 mean {mean} std "
              f"{std} {out_dtype}: max_abs_err {err:.3g} (tol 0)", flush=True)
        if err > 0 or got.shape != want.shape or not torch.isfinite(got.float()).all():
            fail(f"shift_normalize at pad 0 disagrees with its plain version on {tag} "
                 f"{tuple(imgs.shape)} {out_dtype}")
        err_max = max(err_max, err)
    return err_max


def phase_kernel_pad0(dev: torch.device) -> dict:
    """(a) The kernel at pad 0 with zero offsets, the val transform's
    scale/normalize with the preset's val mean and std, against its plain
    version bit for bit on the evaluations' 1 (interactive), 2, 4 and 8
    frames per camera and dispatch and on 32; then its device time at 8
    frames per camera."""
    from hulc2_torch.tools import bench_shift_normalize as bench

    err_max = 0.0
    for n in sorted({1, SINGLE_ENVS, SWEEP_ENVS, DISK_ENVS // DISK_COHORTS,
                     EVAL_ENVS // EVAL_COHORTS, 32}):
        for seed, (cam, hw) in enumerate((("rgb_static", 96), ("rgb_gripper", 64))):
            imgs, _ = bench.make_sets(n, hw, 0, 1, dev, seed)[0]
            err_max = max(err_max, check_pad0("pad0", imgs, *val_norm(cam)))
    k = EVAL_ENVS // EVAL_COHORTS
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": err_max}
    for seed, hw in enumerate((96, 64)):
        sets = bench.make_sets(k, hw, 0, bench.SETS, dev, seed)
        totals["ms"] += bench.device_ms(bench.rotating(bench.kernel_fn(0), sets))
        totals["plain_ms"] += bench.device_ms(bench.rotating(bench.plain_fn(0), sets))
        bound_ms, totals["bound_by"] = bench.bound(k, hw, 2)
        totals["bound_ms"] += bound_ms
    print(f"[pad0] per eval dispatch ({k} frames of 96x96 and of 64x64, bf16 out): kernel "
          f"{totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, bound {totals['bound_ms']:.5f} "
          f"ms ({totals['bound_by']})", flush=True)
    return totals


def phase_renderer(dev: torch.device) -> None:
    """(b) The device renderer on the card against itself on the CPU."""
    from hulc2_torch.envs.render_torch import make_render_obs_fn
    from hulc2_torch.tools.profile_eval import perturbed_states

    scenes, robots = perturbed_states(32, seed=11)
    out = {}
    for d in (torch.device("cpu"), dev):
        fn = make_render_obs_fn(96, 64, with_depth=True, device=d)
        with torch.inference_mode():
            res = fn(torch.from_numpy(scenes).to(d), torch.from_numpy(robots).to(d))
        out[d.type] = {k: v.cpu() for k, v in res.items()}
    for key in ("rgb_static", "rgb_gripper"):
        diff = (out["cpu"][key].int() - out["cuda"][key].int()).abs()
        over, off = (diff > 1).float().mean().item(), (diff != 0).float().mean().item()
        print(f"[render] {key} 32 envs: max diff {diff.max().item()} LSB, share off {off:.3g}, "
              f"share off by more than 1: {over:.3g}", flush=True)
        if over > 0 or off >= 1e-4:
            fail(f"the card renderer's {key} leaves the bounds")
    depth_err = (out["cpu"]["depth_static"] - out["cuda"]["depth_static"]).abs().max().item()
    print(f"[render] depth_static: max abs err {depth_err:.3g} (tol 1e-5)", flush=True)
    if not depth_err < 1e-5:
        fail("the card renderer's depth leaves the bound")


def phase_policy_step(dev: torch.device) -> None:
    """(c) A small fp32 policy's fused render+policy step through the agent,
    card against CPU, same weights and draws, 40 steps with a replan at 0 and
    30 and one env restarted at step 17."""
    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.models.build import build_policy
    from hulc2_torch.models.hulc2 import PolicyDraws
    from hulc2_torch.tools.profile_eval import perturbed_states
    from hulc2_torch.utils.clip_tokenizer import tokenize
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    cfg = flagship_config(SMALL_OVERRIDES)
    k, steps = 4, 40
    agents = {}
    for d in (torch.device("cpu"), dev):
        model = build_policy(cfg["model"], seed=5).to(d).eval()
        agents[d.type] = Hulc2Agent(model, cfg["datamodule"], n_envs=k,
                                    device_render={"static_hw": 96, "gripper_hw": 64})
    scenes, robots = perturbed_states(steps * k, seed=12)
    lang = tokenize(["open the drawer", "turn on the led", "push the red block to the left",
                     "stack the blocks"])
    mc = cfg["model"]
    g = torch.Generator().manual_seed(13)
    worst = 0.0
    for t in range(steps):
        if t == 17:
            for agent in agents.values():
                agent.reset_env_slot(2)
        obs = {"robot_obs": robots[t * k:(t + 1) * k], "scene_obs": scenes[t * k:(t + 1) * k]}
        draws = PolicyDraws(
            -torch.log(-torch.log(torch.rand((k, mc["distribution"]["category_size"],
                                              mc["distribution"]["class_size"]), generator=g))),
            1e-5 + (1 - 2e-5) * torch.rand((k, 1, 6, mc["action_decoder"]["n_mixtures"]), generator=g),
            1e-5 + (1 - 2e-5) * torch.rand((k, 1, 6), generator=g))
        acts = {}
        for name, agent in agents.items():
            d_draws = PolicyDraws(*(x.to(agent.device) for x in draws))
            acts[name] = agent.step_async(obs, {"lang": lang}, d_draws).cpu()
        err = (acts["cpu"] - acts["cuda"]).abs().max().item()
        worst = max(worst, err)
        if not torch.isfinite(acts["cuda"]).all() or err > 1e-3:
            fail(f"card and CPU policy steps disagree at step {t}: max abs err {err}")
    steps_cuda = agents["cuda"].carry.step.cpu().tolist()
    print(f"[policy_step] small fp32 policy, {k} envs, {steps} steps: actions max abs err "
          f"{worst:.3g} (tol 1e-3); step counters {steps_cuda}", flush=True)
    if steps_cuda != [steps, steps, steps - 17, steps]:
        fail(f"step counters {steps_cuda} after {steps} steps with env 2 restarted at 17")


def phase_eval(dev: torch.device, card: str) -> dict:
    """(d) The evaluation entry point at full flagship width; returns the
    launch counts of its run."""
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    merged = evaluate_policy.main([
        "--synthetic", "--fake-env", "--device-render", "--n-envs", str(EVAL_ENVS),
        "--cohorts", str(EVAL_COHORTS), "--num-sequences", str(EVAL_CHAINS),
        "--ep-len", str(EVAL_EP_LEN), "--log-dir", str(EVAL_DIR), "--device", "cuda"])
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    results_file = EVAL_DIR / "results.json"
    if not results_file.is_file():
        fail("the evaluation wrote no results.json")
    diag = json.loads((EVAL_DIR / "eval_diagnostics.json").read_text())
    chains = {}
    for r in diag["subtask_records"]:
        chains[r["chain"]] = chains.get(r["chain"], 0) + int(r["success"])
    if len(chains) != EVAL_CHAINS or not all(0 <= v <= 5 for v in chains.values()):
        fail(f"expected {EVAL_CHAINS} chain results in 0..5, got {chains}")
    if not 0.0 <= merged["synthetic"]["avg_seq_len"] <= 5.0:
        fail(f"avg_seq_len out of range: {merged['synthetic']['avg_seq_len']}")
    dispatches = diag["dispatches"]
    if launches["shift_normalize"] != 2 * dispatches:
        fail(f"shift_normalize launched {launches['shift_normalize']} times in {dispatches} "
             f"dispatches, expected {2 * dispatches}")
    rate = diag["total_env_steps"] / diag["wall_clock_s"]
    print(f"[eval] {EVAL_CHAINS} chains, {EVAL_ENVS} envs in {EVAL_COHORTS} cohorts, ep_len "
          f"{EVAL_EP_LEN}, device render, flagship width: avg_seq_len "
          f"{merged['synthetic']['avg_seq_len']:.3f}; {diag['total_env_steps']} env steps in "
          f"{diag['wall_clock_s']:.2f} s of the evaluator's loop = {rate:.1f} env-steps/s; "
          f"{dispatches} dispatches ({1e3 * diag['wall_clock_s'] / dispatches:.2f} ms each); "
          f"whole entry point {wall_s:.1f} s; launches {launches}; on {card}", flush=True)
    print(f"[eval] host time, summed over cohorts: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in diag["timings_s"].items()), flush=True)
    return launches


def phase_dataset() -> dict:
    """(e) The port's generator writes a small expert dataset (96/64 px, token
    annotations) from scratch; returns its frame counts."""
    import numpy as np

    from hulc2_torch.tools import make_expert_dataset

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    make_expert_dataset.main([str(DATA_DIR), "--episodes", str(DATA_EPISODES),
                              "--tasks-per-episode", str(DATA_TASKS), "--val-episodes", "1",
                              "--val-tasks-per-episode", str(DATA_VAL_TASKS), "--lang-tokens",
                              "--holdout-paraphrases", "4", "--seed", "0"])
    seconds = time.perf_counter() - t0
    frames = {}
    for split in ("training", "validation"):
        ids = np.load(DATA_DIR / split / "ep_start_end_ids.npy")
        frames[split] = int(sum(e - s + 1 for s, e in ids))
    frame_bytes = 96 * 96 * 3 + 64 * 64 * 3
    print(f"[dataset] {DATA_EPISODES} training episodes of {DATA_TASKS} tasks, 1 validation "
          f"episode of {DATA_VAL_TASKS}: {frames['training']} + {frames['validation']} frames, "
          f"training store {frames['training'] * frame_bytes} bytes of images, written in "
          f"{seconds:.1f} s", flush=True)
    return frames


def phase_loader(dev: torch.device) -> None:
    """(f) Device-store batches on the card, through the prefetcher, against
    the same plan assembled on the host from the RAM cache
    (``device_store.host_fused_batches``), bit for bit, for the first batches
    of two epochs."""
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.data.datamodule import Hulc2DataModule
    from hulc2_torch.data.device_store import host_fused_batches
    from hulc2_torch.data.loader import DevicePrefetcher

    dm_cfg = flagship_config([f"datamodule.root_data_dir={DATA_DIR}"])["datamodule"]
    host = Hulc2DataModule(dm_cfg, seed=42, device="cpu")
    card = Hulc2DataModule(dm_cfg, seed=42, device=dev)
    host.setup()
    card.setup()
    loader = card.fused_train_iter()
    compared = 0
    for epoch in range(2):
        it = DevicePrefetcher(loader, dev)
        plain = host_fused_batches(host.datasets["vis_training"], host.datasets["lang_training"],
                                   dm_cfg["batch_size_vis"], dm_cfg["batch_size_lang"], 42, epoch)
        for b, (got, want) in enumerate(zip(it, plain)):
            if b == LOADER_BATCHES:
                break
            for k, w in want.items():
                g = got[k].cpu().numpy()
                if g.dtype != w.dtype or g.shape != w.shape or not (g == w).all():
                    fail(f"device-store batch {b} of epoch {epoch} differs from the host plan on {k}")
            compared += 1
        it.close()
    print(f"[loader] {compared} device-store batches of 2 epochs equal the host plan bit for bit "
          f"(tol 0; {len(loader)} batches per epoch, {card.val_batches()} val batches)", flush=True)
    return host


def phase_val_kernel(dev: torch.device, dm) -> float:
    """(g) The kernel at the validation step's shapes: each camera of each
    modality of the first validation batch (``dm.val_iter``, the batches the
    trainer's val steps read), moved to the card, through the kernel and its
    plain version with the val pipelines' mean and std, tolerance 0."""
    batches = dm.val_iter()
    batch = next(batches)
    batches.close()
    err_max = 0.0
    for m, window in batch.items():
        for cam in dm.cfg["observation_space"]["rgb_obs"]:
            b, s, h, w, c = window[cam].shape
            imgs = torch.from_numpy(window[cam]).to(dev).reshape(b * s, h, w, c)
            err_max = max(err_max, check_pad0(f"val {m} {cam}", imgs, *val_norm(cam)))
    return err_max


def phase_disk_train(dev: torch.device, card: str) -> tuple:
    """(g) ``python -m hulc2_torch.training`` from the dataset at full flagship
    width: one epoch, then the same command resumed to a second; each run
    with the launch counts reset just before and read just after."""
    from hulc2_torch import kernels, training

    shutil.rmtree(DISK_RUN, ignore_errors=True)
    argv = ["--run-dir", str(DISK_RUN), "--device", "cuda", f"datamodule.root_data_dir={DATA_DIR}",
            f"trainer.limit_train_batches={DISK_STEPS}", f"trainer.limit_val_batches={DISK_VAL}",
            "trainer.log_every_n_steps=1"]
    results, launches = [], []
    for epochs in (1, 2):
        kernels.reset_launch_counts()
        results.append(training.main(argv + ["--max-epochs", str(epochs)]))
        torch.cuda.synchronize(dev)
        launches.append(dict(kernels.LAUNCHES))
    first, second = results
    if first.resumed_from is not None or second.resumed_from != DISK_STEPS:
        fail(f"the second run resumed from {second.resumed_from}, expected {DISK_STEPS}")
    if (first.step, second.step) != (DISK_STEPS, 2 * DISK_STEPS):
        fail(f"runs ended at steps {first.step}, {second.step}")
    steps = [DISK_STEPS, 2 * DISK_STEPS]
    ckpts = sorted(int(p.stem) for p in (DISK_RUN / "saved_models").glob("*.pt"))
    if ckpts != steps or not (DISK_RUN / "config.json").is_file():
        fail(f"checkpoints {ckpts} (expected {steps}) or config.json missing")
    for r in results:
        if len(r.history) != DISK_STEPS or len(r.val_history) != 1:
            fail(f"{len(r.history)} train lines and {len(r.val_history)} val lines logged")
        bad = [k for line in r.history + r.val_history for k, v in line.items()
               if not math.isfinite(v)]
        if bad:
            fail(f"non-finite metrics: {sorted(set(bad))}")
    for n in launches:
        if n["shift_normalize"] != 2 * DISK_STEPS + 4 * DISK_VAL:
            fail(f"shift_normalize launched {n['shift_normalize']} times for {DISK_STEPS} train "
                 f"and {DISK_VAL} val steps, expected {2 * DISK_STEPS + 4 * DISK_VAL}")
    steady = [(t, w) for r in results for t, w in zip(r.step_ms[WARM_STEPS:], r.wait_ms[WARM_STEPS:])]
    step_ms = statistics.median(t for t, _ in steady)
    wait_ms = statistics.median(w for _, w in steady)
    val = second.val_history[0]
    print(f"[disk] losses: " + ", ".join(f"{line['train/loss']:.4f}" for r in results
                                         for line in r.history), flush=True)
    print(f"[disk] val after epoch 2: " + ", ".join(
        f"{k[4:]} {v:.4f}" for k, v in val.items() if k.startswith("val/")), flush=True)
    print(f"[disk] 2 runs x {DISK_STEPS} steps + {DISK_VAL} val batches, resumed from step "
          f"{second.resumed_from}; launches {launches}; step time {step_ms:.2f} ms (median of "
          f"{len(steady)} steps after {WARM_STEPS} warm-up steps per run, each ending in a fetch "
          f"of its metrics), of which waiting on the prefetcher {wait_ms:.3f} ms "
          f"({100 * wait_ms / step_ms:.1f}%); device store {second.store_nbytes} bytes resident, "
          f"uploaded in {first.store_upload_s:.3f} s and {second.store_upload_s:.3f} s; on {card}",
          flush=True)
    total = {k: sum(n[k] for n in launches) for k in launches[0]}
    return second.model, total


def phase_disk_eval(dev: torch.device, card: str, trained) -> dict:
    """(h) ``evaluate_policy --train-dir`` on the trained run: the loaded
    parameters equal the newest checkpoint's and the trained model's, and
    the kernel launches twice per dispatch."""
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy
    from hulc2_torch.evaluation.loading import load_policy

    model, _, step = load_policy(DISK_RUN)
    saved = torch.load(DISK_RUN / "saved_models" / f"{2 * DISK_STEPS}.pt", map_location="cpu",
                       weights_only=True)["model"]
    mine = {k: v.cpu() for k, v in trained.state_dict().items()}
    loaded = model.state_dict()
    if step != 2 * DISK_STEPS or not all(torch.equal(loaded[k], saved[k]) and torch.equal(loaded[k], mine[k])
                                         for k in saved):
        fail("the evaluation's parameters differ from the checkpoint's")
    log_dir = DISK_RUN / "evaluation"
    shutil.rmtree(log_dir, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    merged = evaluate_policy.main([
        "--train-dir", str(DISK_RUN), "--fake-env", "--device-render", "--n-envs", str(DISK_ENVS),
        "--cohorts", str(DISK_COHORTS), "--num-sequences", str(DISK_CHAINS), "--ep-len",
        str(EVAL_EP_LEN), "--device", "cuda"])
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if not (log_dir / "results.json").is_file():
        fail("the evaluation of the trained run wrote no results.json")
    diag = json.loads((log_dir / "eval_diagnostics.json").read_text())
    if not 0.0 <= merged["latest"]["avg_seq_len"] <= 5.0 or \
            len({r["chain"] for r in diag["subtask_records"]}) != DISK_CHAINS:
        fail(f"unexpected results: {merged['latest']}")
    if launches["shift_normalize"] != 2 * diag["dispatches"]:
        fail(f"shift_normalize launched {launches['shift_normalize']} times in "
             f"{diag['dispatches']} dispatches")
    print(f"[disk_eval] step {step} of {DISK_RUN.name}: {len(saved)} parameter tensors equal the "
          f"checkpoint's; {DISK_CHAINS} chains, {DISK_ENVS} envs in {DISK_COHORTS} cohorts: "
          f"avg_seq_len {merged['latest']['avg_seq_len']:.3f}; {diag['total_env_steps']} env "
          f"steps in {diag['wall_clock_s']:.2f} s, {diag['dispatches']} dispatches; whole entry "
          f"point {wall_s:.1f} s; launches {launches}; on {card}", flush=True)
    return launches


def phase_detector(dev: torch.device) -> None:
    """(i) The full-width detector in fp32 on the card against the CPU, same
    weights, 8 frames of 96x96 at 224 and 8 validation sentences."""
    import numpy as np

    from hulc2_torch.affordance.train_affordance import build_detector
    from hulc2_torch.configs.affordance import affordance_config
    from hulc2_torch.ops.preprocess import resize
    from hulc2_torch.tools.annotations import VALIDATION_BANK
    from hulc2_torch.utils.clip_tokenizer import tokenize
    from hulc2_torch.utils.device import set_precision_flags

    set_precision_flags()
    cfg = affordance_config()
    frames = torch.from_numpy(np.random.default_rng(21).integers(
        0, 256, (AFF_FRAMES, 96, 96, 3), dtype=np.uint8))
    toks = torch.from_numpy(tokenize(list(VALIDATION_BANK.values())[:AFF_FRAMES]))
    out = {}
    for d in (torch.device("cpu"), dev):
        model = build_detector(cfg["aff_detection"], seed=22).to(d).eval()
        with torch.no_grad():
            imgs = resize(frames.to(d).float() / 255.0, 224, 224)
            o = model(imgs, toks.to(d))
            px, _, _ = model.predict_from_output(o, torch.zeros((AFF_FRAMES, 1), device=d), None)
        out[d.type] = {"imgs": imgs.cpu(), "logits": o.aff_logits.cpu(), "mu": o.depth_pred[0].cpu(),
                       "sigma": o.depth_pred[1].cpu(), "px": px.cpu()}
    cpu, card = out["cpu"], out["cuda"]
    resize_err = (cpu["imgs"] - card["imgs"]).abs().max().item()
    tol = 1e-3 * max(1.0, cpu["logits"].abs().max().item())
    errs = {k: (cpu[k] - card[k]).abs().max().item() for k in ("logits", "mu", "sigma")}
    top2 = cpu["logits"].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = (cpu["px"] == card["px"]).all(dim=-1)
    print(f"[detector] rn18_tokens_pixel fp32, {AFF_FRAMES} frames 96->224: resize max abs err "
          f"{resize_err:.3g} (tol 1e-5); " + ", ".join(f"{k} max abs err {v:.3g}" for k, v in
                                                        errs.items())
          + f" (tol {tol:.3g}); pixels equal {int(same.sum())}/{AFF_FRAMES}, "
          f"{int(clear.sum())} with a top-two margin over {2 * tol:.3g}", flush=True)
    if resize_err > 1e-5 or max(errs.values()) > tol:
        fail(f"the detector on the card disagrees with the CPU: resize {resize_err}, {errs}")
    if not bool(same[clear].all()):
        fail("the detector's argmax pixel differs where the logits' margin is clear")


def phase_mining() -> dict:
    """(j) Labels mined from (e)'s dataset; returns the labels per split."""
    from hulc2_torch.affordance import dataset_creation

    shutil.rmtree(AFF_DATA, ignore_errors=True)
    t0 = time.perf_counter()
    info = dataset_creation.main([str(DATA_DIR), "--out-dir", str(AFF_DATA),
                                  "--holdout-paraphrases", "4"])
    seconds = time.perf_counter() - t0
    labels = {split: sum(len(c["static_cam"]) for c in info[split].values())
              for split in ("training", "validation")}
    print(f"[mining] {labels['training']} training and {labels['validation']} validation labels "
          f"mined in {seconds:.1f} s; depth norm {info['norm_values']['depth']['static_cam']}",
          flush=True)
    if not all(labels.values()):
        fail(f"label mining found no labels in a split: {labels}")
    return labels


def phase_aff_train(dev: torch.device, card: str, labels: dict):
    """(k) The detector trained on the mined labels at batch 32; returns the
    trained model."""
    from hulc2_torch.affordance import train_affordance
    from hulc2_torch.configs.affordance import affordance_config

    cfg = affordance_config()
    per_epoch = labels["training"] // cfg["batch_size"]
    if per_epoch < 1:
        fail(f"{labels['training']} training labels make no batch of {cfg['batch_size']}")
    epochs = -(-AFF_STEPS // per_epoch)
    shutil.rmtree(AFF_RUN, ignore_errors=True)
    result = train_affordance.main(["--run-dir", str(AFF_RUN), "--device", "cuda", "--max-epochs",
                                    str(epochs), "--max-steps", str(AFF_STEPS),
                                    "aff_detection=rn18_tokens_pixel",
                                    f"aff_detection.dataset.data_dir={AFF_DATA}"])
    torch.cuda.synchronize(dev)
    if result.step != AFF_STEPS or len(result.history) != AFF_STEPS or len(result.val_history) != epochs:
        fail(f"{result.step} steps, {len(result.history)} train and {len(result.val_history)} val "
             f"lines, expected {AFF_STEPS} steps and {epochs} validations")
    bad = sorted({k for line in result.history + result.val_history for k, v in line.items()
                  if not math.isfinite(v)})
    if bad or "val/px_dist_err" not in result.val_history[-1]:
        fail(f"non-finite or missing metrics: {bad}")
    run_cfg = json.loads((AFF_RUN / "config.json").read_text())
    if set(run_cfg.get("depth_norm", {})) != {"mean", "std"}:
        fail("config.json holds no depth_norm")
    if not (AFF_RUN / "saved_models" / f"{AFF_STEPS}.pt").is_file():
        fail("no checkpoint of the last step")
    fresh = train_affordance.build_detector(cfg["aff_detection"], cfg["seed"]).state_dict()
    trained = {k: v.cpu() for k, v in result.model.state_dict().items()}
    encoder = [k for k in fresh if k.startswith("aff_stream.encoder.")]
    if not encoder or not all(torch.equal(fresh[k], trained[k]) for k in encoder):
        fail("the frozen encoder's parameters or statistics changed")
    trainable = [n for n, p in result.model.named_parameters() if p.requires_grad]
    moved = [n for n in trainable if not torch.equal(fresh[n], trained[n])]
    if len(moved) < 0.9 * len(trainable) or not any(n.startswith("lang_tower.") for n in moved) \
            or not any(n.startswith("aff_stream.decoder.") for n in moved):
        fail(f"only {len(moved)} of {len(trainable)} trainable tensors moved")
    steady = [line["step_ms"] for line in result.history[WARM_STEPS:]]
    val = result.val_history[-1]
    print(f"[aff_train] {AFF_STEPS} steps at batch {cfg['batch_size']} over {epochs} epochs of "
          f"{per_epoch}: losses " + ", ".join(f"{line['total_loss']:.4f}" for line in result.history),
          flush=True)
    print(f"[aff_train] val: " + ", ".join(f"{k[4:]} {v:.4f}" for k, v in val.items()
                                           if k.startswith("val/")), flush=True)
    print(f"[aff_train] {len(moved)}/{len(trainable)} trainable tensors moved, {len(encoder)} encoder "
          f"tensors bit-equal; step time {statistics.median(steady):.2f} ms (median of steps "
          f"{WARM_STEPS}..{AFF_STEPS - 1}, spread {min(steady):.1f}-{max(steady):.1f} ms, host "
          f"clock per step incl. the batch's copy and a fetch of its metrics; step 0 "
          f"{result.history[0]['step_ms']:.1f} ms); on {card}", flush=True)
    return result.model


def phase_hier_eval(dev: torch.device, card: str, trained) -> dict:
    """(l) The hierarchical eval of the disk run with (k)'s detector; returns
    the launch counts of its run."""
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy
    from hulc2_torch.evaluation.loading import load_affordance

    pred = load_affordance(AFF_RUN, device=dev)
    saved = torch.load(AFF_RUN / "saved_models" / f"{AFF_STEPS}.pt", map_location="cpu",
                       weights_only=True)["model"]
    loaded = {k: v.cpu() for k, v in pred.model.state_dict().items()}
    mine = {k: v.cpu() for k, v in trained.state_dict().items()}
    if not all(torch.equal(loaded[k], saved[k]) and torch.equal(loaded[k], mine[k]) for k in saved):
        fail("the evaluation's detector differs from the checkpoint")
    del pred
    shutil.rmtree(HIER_DIR, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    merged = evaluate_policy.main([
        "--train-dir", str(DISK_RUN), "--aff-train-dir", str(AFF_RUN), "--fake-env",
        "--device-render", "--n-envs", str(DISK_ENVS), "--cohorts", str(DISK_COHORTS),
        "--num-sequences", str(DISK_CHAINS), "--ep-len", str(EVAL_EP_LEN), "--log-dir",
        str(HIER_DIR), "--device", "cuda"])
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if not (HIER_DIR / "results.json").is_file():
        fail("the hierarchical evaluation wrote no results.json")
    diag = json.loads((HIER_DIR / "eval_diagnostics.json").read_text())
    h, records = diag["hierarchical"], diag["subtask_records"]
    if not 0.0 <= merged["latest"]["avg_seq_len"] <= 5.0 or len({r["chain"] for r in records}) != DISK_CHAINS:
        fail(f"unexpected results: {merged['latest']}")
    if h["aff_predictions"] != len(records) or h["approaches"] < 1:
        fail(f"{h} for {len(records)} subtask starts")
    if h["approach_steps"] != sum(r["approach_steps"] for r in records):
        fail("the approach steps of the records do not add up")
    if launches["shift_normalize"] != 2 * diag["dispatches"]:
        fail(f"shift_normalize launched {launches['shift_normalize']} times in "
             f"{diag['dispatches']} dispatches")
    rate = diag["total_env_steps"] / diag["wall_clock_s"]
    flush_ms = 1e3 * diag["timings_s"]["aff_flush_s"] / h["aff_predictions"]
    print(f"[hier_eval] step {2 * DISK_STEPS} of {DISK_RUN.name} with step {AFF_STEPS} of "
          f"{AFF_RUN.name} ({len(saved)} detector tensors equal the checkpoint's): {DISK_CHAINS} "
          f"chains, {DISK_ENVS} envs in {DISK_COHORTS} cohorts, avg_seq_len "
          f"{merged['latest']['avg_seq_len']:.3f}; {h['aff_predictions']} affordance predictions, "
          f"{h['approaches']} approaches, {h['approach_steps']} approach steps; "
          f"{diag['total_env_steps']} env steps in {diag['wall_clock_s']:.2f} s = {rate:.1f} "
          f"env-steps/s, {diag['dispatches']} dispatches; aff_flush_s {flush_ms:.2f} ms per "
          f"prediction; whole entry point {wall_s:.1f} s; launches {launches}; on {card}", flush=True)
    print(f"[hier_eval] host time, summed over cohorts: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in diag["timings_s"].items()), flush=True)
    return launches


def eval_diag(log_dir: Path, what: str) -> dict:
    """``eval_diagnostics.json`` of an evaluation that must have written
    ``results.json`` beside it."""
    if not (log_dir / "results.json").is_file():
        fail(f"the {what} wrote no results.json")
    return json.loads((log_dir / "eval_diagnostics.json").read_text())


def check_launches(launches: dict, n: int, what: str) -> None:
    if launches["shift_normalize"] != 2 * n:
        fail(f"{what}: shift_normalize launched {launches['shift_normalize']} times, expected "
             f"2 x {n}")


def phase_paraphrase(dev: torch.device, card: str) -> dict:
    """(m) The hierarchical eval of (l) under the paraphrase protocol: the
    policy and the detector get each task's held-out sentences."""
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy

    shutil.rmtree(PARA_DIR, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    merged = evaluate_policy.main([
        "--train-dir", str(DISK_RUN), "--aff-train-dir", str(AFF_RUN), "--paraphrase-eval",
        "--fake-env", "--device-render", "--n-envs", str(DISK_ENVS), "--cohorts",
        str(DISK_COHORTS), "--num-sequences", str(DISK_CHAINS), "--ep-len", str(EVAL_EP_LEN),
        "--log-dir", str(PARA_DIR), "--device", "cuda"])
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    diag = eval_diag(PARA_DIR, "paraphrase evaluation")
    h, records = diag["hierarchical"], diag["subtask_records"]
    if diag["paraphrase_eval"] is not True or len({r["chain"] for r in records}) != DISK_CHAINS:
        fail(f"paraphrase eval: {diag['paraphrase_eval']}, {merged['latest']}")
    if h["aff_predictions"] != len(records):
        fail(f"{h['aff_predictions']} affordance predictions for {len(records)} subtask starts")
    check_launches(launches, diag["dispatches"], "paraphrase eval")
    rate = diag["total_env_steps"] / diag["wall_clock_s"]
    flush_ms = 1e3 * diag["timings_s"]["aff_flush_s"] / max(h["aff_predictions"], 1)
    print(f"[para_eval] held-out paraphrases, step {2 * DISK_STEPS} of {DISK_RUN.name} with "
          f"{AFF_RUN.name}: {DISK_CHAINS} chains, {DISK_ENVS} envs in {DISK_COHORTS} cohorts, "
          f"avg_seq_len {merged['latest']['avg_seq_len']:.3f}; {h['aff_predictions']} "
          f"predictions, {h['approaches']} approaches, {h['approach_steps']} approach steps; "
          f"{diag['total_env_steps']} env steps in {diag['wall_clock_s']:.2f} s = {rate:.1f} "
          f"env-steps/s, {diag['dispatches']} dispatches; aff_flush_s {flush_ms:.2f} ms per "
          f"prediction; whole entry point {wall_s:.1f} s; launches {launches}; on {card}",
          flush=True)
    return launches


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_sweep(dev: torch.device, card: str) -> dict:
    """(n) ``evaluate_policy --all-checkpoints`` over the disk run's two
    steps: both in one results.json, "best" the higher avg_seq_len, two
    launches per dispatch of each step (read from each step's log line)."""
    import re

    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy

    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    log = logging.getLogger("hulc2_torch.evaluation.evaluate_policy")
    handler, level = _Messages(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        evaluate_policy.main([
            "--train-dir", str(DISK_RUN), "--all-checkpoints", "--fake-env", "--device-render",
            "--n-envs", str(SWEEP_ENVS), "--num-sequences", str(SWEEP_CHAINS), "--ep-len",
            str(EVAL_EP_LEN), "--log-dir", str(SWEEP_DIR), "--device", "cuda"])
        torch.cuda.synchronize(dev)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    eval_diag(SWEEP_DIR, "sweep")
    results = json.loads((SWEEP_DIR / "results.json").read_text())
    steps = [str(DISK_STEPS), str(2 * DISK_STEPS)]
    if sorted(k for k in results if k != "best") != sorted(steps):
        fail(f"the sweep's results.json holds {sorted(results)}, expected {steps} and best")
    top = max(results[s]["avg_seq_len"] for s in steps)
    best = results["best"]
    if best["avg_seq_len"] != top or results[best["epoch"]]["avg_seq_len"] != top:
        fail(f"best is {best['epoch']} at {best['avg_seq_len']}, the top avg_seq_len is {top}")
    runs = [re.search(r"(\d+) env steps in ([\d.]+) s .*, (\d+) dispatches", m)
            for m in handler.messages if m.startswith("evaluation:")]
    if len(runs) != len(steps) or None in runs:
        fail(f"expected one evaluation line per step, got {handler.messages}")
    dispatches = sum(int(m.group(3)) for m in runs)
    check_launches(launches, dispatches, "sweep")
    env_steps = sum(int(m.group(1)) for m in runs)
    loop_s = sum(float(m.group(2)) for m in runs)
    print(f"[sweep] --all-checkpoints over steps {steps} of {DISK_RUN.name}, {SWEEP_CHAINS} "
          f"chains each on {SWEEP_ENVS} envs: avg_seq_len " + ", ".join(
              f"{s} {results[s]['avg_seq_len']:.3f}" for s in steps)
          + f", best {best['epoch']}; {env_steps} env steps in {loop_s:.1f} s of the loops = "
          f"{env_steps / loop_s:.1f} env-steps/s, {dispatches} dispatches; whole sweep "
          f"{wall_s:.1f} s; launches {launches}; on {card}", flush=True)
    return launches


def phase_single_step(dev: torch.device, card: str) -> dict:
    """(o) ``evaluate_policy --single-step --dataset-path`` on the disk run:
    one job per oracle-detected validation window, one subtask each."""
    from hulc2_torch import kernels
    from hulc2_torch.evaluation import evaluate_policy, harness

    jobs = harness.dataset_singlestep_sequences(DATA_DIR / "validation")
    shutil.rmtree(SINGLE_DIR, ignore_errors=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    merged = evaluate_policy.main([
        "--train-dir", str(DISK_RUN), "--single-step", "--dataset-path", str(DATA_DIR),
        "--fake-env", "--device-render", "--n-envs", str(SINGLE_ENVS), "--ep-len",
        str(EVAL_EP_LEN), "--log-dir", str(SINGLE_DIR), "--device", "cuda"])
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    diag = eval_diag(SINGLE_DIR, "single-step evaluation")
    records = diag["subtask_records"]
    if not jobs or diag["num_sequences"] != len(jobs) or len(records) != len(jobs) \
            or sorted(r["chain"] for r in records) != list(range(len(jobs))) \
            or any(r["pos"] != 0 for r in records):
        fail(f"{len(jobs)} single-step jobs, {diag['num_sequences']} evaluated, records "
             f"{[(r['chain'], r['pos']) for r in records]}")
    check_launches(launches, diag["dispatches"], "single-step eval")
    rate = diag["total_env_steps"] / diag["wall_clock_s"]
    print(f"[single_step] {len(jobs)} jobs from the validation split "
          f"({', '.join(c[0] for _, c in jobs)}), {SINGLE_ENVS} envs: SR "
          f"{merged['latest']['chain_sr'][1]:.3f}; {diag['total_env_steps']} env steps in "
          f"{diag['wall_clock_s']:.2f} s = {rate:.1f} env-steps/s, {diag['dispatches']} "
          f"dispatches; whole entry point {wall_s:.1f} s; launches {launches}; on {card}",
          flush=True)
    return launches


def phase_interactive(dev: torch.device, card: str) -> dict:
    """(p) ``interactive.main`` on the disk run with two instructions on a
    StringIO stdin, one of them from the offline planner."""
    import contextlib
    import io

    from hulc2_torch import kernels
    from hulc2_torch.evaluation import interactive
    from hulc2_torch.evaluation.llm_planning import LLMPlanner

    planned = LLMPlanner().instructions("please turn on the led")
    if not planned:
        fail("the keyword planner planned nothing for 'please turn on the led'")
    instructions = ["open the drawer", planned[0]]
    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        verdicts = interactive.main(["--train-dir", str(DISK_RUN), "--fake-env", "--ep-len",
                                     str(INTERACTIVE_EP_LEN), "--device", "cuda"],
                                    stdin=io.StringIO("\n".join(instructions) + "\n"))
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    lines = [line for line in out.getvalue().splitlines() if line.startswith("-> ")]
    if len(lines) != len(instructions) or [v[0] for v in verdicts] != instructions:
        fail(f"expected one verdict line per instruction, got {lines}")
    steps = sum(v[2] for v in verdicts)
    check_launches(launches, steps, "interactive")
    print(f"[interactive] {instructions} -> {lines}; {steps} env steps in {wall_s:.2f} s of the "
          f"entry point = {steps / wall_s:.1f} env-steps/s (one env, host render, one fetch per "
          f"step, the policy's load included); launches {launches}; on {card}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    try:
        import hulc2_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the hulc2_torch package is not importable from here: {exc}")
    dev = torch.device("cuda", 0)
    # the trainer's lines (epochs, the resume, checkpoints) and warnings
    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    logging.getLogger("hulc2_torch.train.trainer").setLevel(logging.INFO)
    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    phase_build()
    kernel = phase_kernel_vs_plain(dev)
    phase_reference(dev)
    phase_bf16_vs_fp32(dev)
    launches = phase_main_path(dev, card)
    pad0 = phase_kernel_pad0(dev)
    phase_renderer(dev)
    phase_policy_step(dev)
    eval_launches = phase_eval(dev, card)
    phase_dataset()
    host_dm = phase_loader(dev)
    trained, disk_launches = phase_disk_train(dev, card)
    val_err = phase_val_kernel(dev, host_dm)
    disk_eval_launches = phase_disk_eval(dev, card, trained)
    phase_detector(dev)
    labels = phase_mining()
    detector = phase_aff_train(dev, card, labels)
    hier_launches = phase_hier_eval(dev, card, detector)
    para_launches = phase_paraphrase(dev, card)
    sweep_launches = phase_sweep(dev, card)
    single_launches = phase_single_step(dev, card)
    interactive_launches = phase_interactive(dev, card)

    entry = {
        "name": "shift_normalize",
        "route": "cuda",
        "source": "hulc2_torch/csrc/shift_normalize.cu",
        "replaces": "hulc2_tpu/ops/pallas_shift.py:52",
        "launches": sum(n["shift_normalize"] for n in (
            launches, eval_launches, disk_launches, disk_eval_launches, hier_launches,
            para_launches, sweep_launches, single_launches, interactive_launches)),
        "max_abs_err": max(kernel["max_abs_err"], pad0["max_abs_err"], val_err),
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": None,
        "launches_by_path": {"train": launches["shift_normalize"],
                             "eval": eval_launches["shift_normalize"],
                             "disk_train": disk_launches["shift_normalize"],
                             "disk_eval": disk_eval_launches["shift_normalize"],
                             "hier_eval": hier_launches["shift_normalize"],
                             "para_eval": para_launches["shift_normalize"],
                             "sweep": sweep_launches["shift_normalize"],
                             "single_step": single_launches["shift_normalize"],
                             "interactive": interactive_launches["shift_normalize"]},
        "eval_dispatch": {k: pad0[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
    }
    print(f"[kernels] ms, plain_ms and bound_ms are device times per train step, one rgb_static "
          f"and one rgb_gripper launch (a bf16 cast of the same bytes takes "
          f"{kernel['cast_ms']:.4f} ms); eval_dispatch holds the same per eval dispatch at pad 0",
          flush=True)
    print(f"[time] all phases {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
