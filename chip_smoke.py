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
7. the kernels line, the card line, and the final JSON line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

MAIN_STEPS = 10
WARM_STEPS = 2  # steps 0 and 1 carry cuDNN's algorithm search and allocator growth
RUN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_run"


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


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    try:
        import hulc2_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the hulc2_torch package is not importable from here: {exc}")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    phase_build()
    kernel = phase_kernel_vs_plain(dev)
    phase_reference(dev)
    phase_bf16_vs_fp32(dev)
    launches = phase_main_path(dev, card)

    entry = {
        "name": "shift_normalize",
        "route": "cuda",
        "source": "hulc2_torch/csrc/shift_normalize.cu",
        "replaces": "hulc2_tpu/ops/pallas_shift.py:52",
        "launches": launches["shift_normalize"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": None,
    }
    print(f"[kernels] times are device times per train step, one rgb_static and one rgb_gripper "
          f"launch; a bf16 cast of the same bytes takes {kernel['cast_ms']:.4f} ms", flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
