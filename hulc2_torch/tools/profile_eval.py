"""Where the time of one evaluation dispatch goes, on the card.

    python -m hulc2_torch.tools.profile_eval [--k 8] [--steps 20] [--warmup 5]
        [--trace OUT.json] [key=value ...]

One dispatch is the fused render+policy step of the device-render evaluation
(``train/steps.make_fused_render_policy_step``) for one cohort of ``--k``
fake envs, flagship policy at full width (bf16 autocast), goals the token ids
of canonical instructions, states the evaluation chains' initial states with
perturbed robot poses. It takes ``--warmup`` steps, then times ``--steps``
more on the host clock, each ending in a device synchronise (the latency of
a dispatch with nothing to overlap it), then runs ``--steps`` under
``torch.profiler`` and prints per dispatch: the device-busy time (union of
the kernels' intervals), the idle share of the unprofiled wall time, the
count of device activities, the device time by kernel family and the top
kernels. Then the renderer alone, ``--steps`` calls under the profiler (its
device busy time and activities per call: it launches too many kernels to
queue 50 calls behind a spin kernel), and one shift_normalize launch at pad
0 per camera, from 50 back-to-back launches between CUDA events
(``bench_shift_normalize.device_ms``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hulc2_torch.evaluation.initial_states import get_env_state_for_initial_condition
from hulc2_torch.evaluation.sequences import get_sequences


def perturbed_states(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(scene_obs (n, 24), robot_obs (n, 15)) float32: the initial states of
    the first ``n`` evaluation chains, with the TCP moved over the table, its
    yaw turned and the gripper opened or closed at random (seeded), so that
    the fingers and the wrist camera see varied scenes."""
    rng = np.random.default_rng(seed)
    scenes, robots = [], []
    for state, _ in get_sequences(n)[:n]:
        robot, scene = get_env_state_for_initial_condition(dict(state))
        robot = np.array(robot, np.float64)
        robot[:3] += [rng.uniform(-0.25, 0.25), rng.uniform(-0.2, 0.15), rng.uniform(-0.1, 0.1)]
        robot[5] = rng.uniform(-2.0, 2.0)
        robot[14] = rng.choice([-1.0, 1.0])
        scenes.append(scene)
        robots.append(robot)
    return np.stack(scenes).astype(np.float32), np.stack(robots).astype(np.float32)


class EvalDispatch:
    """The fused render+policy step of one cohort of ``k`` envs on ``device``,
    with its carry, goals and a rotation of env states already on the device."""

    def __init__(self, k: int, device, overrides: Sequence[str] = (), seed: int = 0):
        from hulc2_torch.configs.flagship import flagship_config
        from hulc2_torch.data.device_transforms import camera_sizes, make_batch_transform
        from hulc2_torch.envs.render_torch import make_render_obs_fn
        from hulc2_torch.evaluation.tasks import TASK_NAMES
        from hulc2_torch.models.build import build_policy
        from hulc2_torch.tools.annotations import VALIDATION_BANK
        from hulc2_torch.train.steps import make_fused_render_policy_step
        from hulc2_torch.utils.clip_tokenizer import tokenize
        from hulc2_torch.utils.device import set_precision_flags

        set_precision_flags()
        self.device = device = torch.device(device)
        cfg = flagship_config(overrides)
        dm = cfg["datamodule"]
        sizes = camera_sizes(dm["transforms"])
        self.model = build_policy(cfg["model"], gripper_hw=sizes["rgb_gripper"],
                                  seed=cfg["seed"]).to(device).eval()
        bf16 = device.type == "cuda" and self.model.compute_dtype == torch.bfloat16
        tf = make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                  dm["transforms"], dtype=torch.bfloat16 if bf16 else torch.float32,
                                  train=False)
        self.render_fn = make_render_obs_fn(sizes["rgb_static"], sizes["rgb_gripper"],
                                            with_depth=False, device=device)
        self.step_fn = make_fused_render_policy_step(self.model, tf, self.render_fn,
                                                     list(dm["observation_space"]["rgb_obs"]))
        tasks = [TASK_NAMES[i % len(TASK_NAMES)] for i in range(k)]
        self.goal = {"lang": torch.from_numpy(tokenize([VALIDATION_BANK[t] for t in tasks])).to(device)}
        scenes, robots = perturbed_states(4 * k, seed)
        self.states = [{"scene_obs": torch.from_numpy(scenes[i * k:(i + 1) * k]).to(device),
                        "robot_obs": torch.from_numpy(robots[i * k:(i + 1) * k]).to(device)}
                       for i in range(4)]
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.carry = self.model.init_carry(k, device)
        self.k = k
        self.calls = 0

    def __call__(self) -> torch.Tensor:
        action, self.carry = self.step_fn(self.states[self.calls % 4], self.goal, self.carry,
                                          self.generator)
        self.calls += 1
        return action


def _profiled(fn, n: int) -> Tuple[float, List, object]:
    """(device busy ms per call, the device events, the profiler) of ``n``
    calls of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from hulc2_torch.tools.profile_train import _union_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    return _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / n, \
        kernels, prof


def _timed(dispatch: EvalDispatch, n: int) -> List[float]:
    times = []
    for _ in range(n):
        torch.cuda.synchronize(dispatch.device)
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize(dispatch.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from hulc2_torch.tools import bench_shift_normalize as bench
    from hulc2_torch.tools.profile_train import family

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--k", type=int, default=8, help="envs per cohort (32 envs in 4 cohorts)")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--trace", default=None, help="write the Chrome trace here")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dispatch = EvalDispatch(args.k, "cuda", args.overrides)
    _timed(dispatch, args.warmup)
    wall = _timed(dispatch, args.steps)
    wall_ms = statistics.median(wall)

    busy_ms, kernels, prof = _profiled(dispatch, args.steps)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    by_name: Dict[str, List[float]] = defaultdict(list)
    for e in kernels:
        by_name[e.name].append(e.time_range.elapsed_us())
    by_family: Dict[str, float] = defaultdict(float)
    for name, times in by_name.items():
        by_family[family(name)] += sum(times) / 1e3 / args.steps

    scenes = [s["scene_obs"] for s in dispatch.states]
    robots = [s["robot_obs"] for s in dispatch.states]
    with torch.inference_mode():
        calls = iter(range(1 << 30))

        def render():
            i = next(calls) % 4
            return dispatch.render_fn(scenes[i], robots[i])

        render()
        render_ms, render_events, _ = _profiled(render, args.steps)
        shift_ms = {}
        for cam, hw in (("rgb_static", 96), ("rgb_gripper", 64)):
            sets = bench.make_sets(args.k, hw, 0, bench.SETS, dispatch.device, seed=hw)
            shift_ms[cam] = bench.device_ms(bench.rotating(bench.kernel_fn(0), sets))

    summary = {
        "card": card, "k": args.k, "wall_ms": wall_ms, "wall_spread_ms": [min(wall), max(wall)],
        "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "device_activities": len(kernels) / args.steps, "render_ms": render_ms,
        "render_activities": len(render_events) / args.steps,
        "shift_normalize_pad0_ms": shift_ms,
        "by_family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
    }
    print(f"card: {card}; torch {torch.__version__}")
    print(f"one dispatch of {args.k} envs (render + transform + policy step): wall {wall_ms:.3f} ms "
          f"(median of {args.steps}, spread {min(wall):.3f}-{max(wall):.3f}), device busy "
          f"{busy_ms:.3f} ms, idle share {100 * summary['idle_share']:.1f}%, "
          f"{summary['device_activities']:.0f} device activities")
    print(f"renderer alone: {render_ms:.4f} ms device busy per dispatch, "
          f"{summary['render_activities']:.0f} device activities; shift_normalize at pad 0: "
          + ", ".join(f"{cam} {args.k}x{hw}x{hw}x3 {ms:.4f} ms" for (cam, ms), hw
                      in zip(shift_ms.items(), (96, 64))))
    print("device time per dispatch by kernel family:")
    for fam, ms in summary["by_family_ms"].items():
        print(f"  {fam:<16} {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%")
    print("top kernels by device time per dispatch:")
    for name, times in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]:
        print(f"  {sum(times) / 1e3 / args.steps:8.3f} ms  x{len(times) // args.steps:<5d} {name[:100]}")
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
