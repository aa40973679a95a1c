"""Device-time breakdown of the affordance detector's train step and prediction.

    python -m hulc2_torch.tools.profile_affordance [--steps 10] [--warmup 3] [key=value ...]

Builds the ``rn18_tokens_pixel`` detector at full width on the card
(``configs/affordance.py`` with dotted overrides) and times, on synthetic
uint8 frames of ``--frame-hw`` px (the expert dataset's 96 by default):

- the train step of ``train_affordance`` (device resize to 224, crop of image
  and label, forward with the decoder's BatchNorm on batch statistics, loss,
  backward, Adam) at the config's batch size: wall time per step (host
  clock, each step ending in a device synchronise), device busy time (union
  of the kernels' intervals under ``torch.profiler``), the idle share, and
  device time by kernel family;
- the hierarchical eval's prediction (``AffordancePredictor.predict_batch``)
  of ``--predict-n`` frames: wall time per call (frames copied to the card,
  one forward, results back on the host) and device busy time.

Prints one JSON line with the numbers last. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _wall_ms(fn, n: int) -> List[float]:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from hulc2_torch.affordance.depth_heads import DepthNorm
    from hulc2_torch.affordance.detector import AffordancePredictor
    from hulc2_torch.affordance.train_affordance import (
        SyntheticAffordanceDataset,
        build_detector,
        input_hw,
        make_aff_train_step,
        to_device,
    )
    from hulc2_torch.configs.affordance import affordance_config
    from hulc2_torch.data.loader import collate
    from hulc2_torch.tools.profile_eval import _profiled
    from hulc2_torch.tools.profile_train import family
    from hulc2_torch.train.optim import make_optimizer
    from hulc2_torch.utils.device import set_precision_flags

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--frame-hw", type=int, default=96)
    parser.add_argument("--predict-n", type=int, default=8)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    set_precision_flags()
    cfg = affordance_config(args.overrides)
    aff, bs, pad = cfg["aff_detection"], cfg["batch_size"], cfg["rand_shift_pad"]
    hw = input_hw(aff)
    model = build_detector(aff, cfg["seed"]).to(dev)
    opt = make_optimizer([p for p in model.parameters() if p.requires_grad], aff["optimizer"])
    step = make_aff_train_step(model, opt, aff["loss_weights"], hw, pad)
    ds = SyntheticAffordanceDataset(4 * bs, args.frame_hw, seed=1)
    batches = [to_device(collate([ds[b * bs + i] for i in range(bs)]), dev) for b in range(4)]
    for b in batches:  # labels at the model's input size
        b["px"] = (b["px"] * hw // args.frame_hw).int()
    g = torch.Generator(device=dev).manual_seed(0)
    calls = iter(range(1 << 30))

    def train_step():
        b = batches[next(calls) % 4]
        offsets = torch.randint(0, 2 * pad + 1, (bs, 2), generator=g, device=dev, dtype=torch.int32)
        return step(b, offsets)

    _wall_ms(train_step, args.warmup)
    wall = _wall_ms(train_step, args.steps)
    busy_ms, kernels, _ = _profiled(train_step, args.steps)
    by_name: Dict[str, List[float]] = defaultdict(list)
    for e in kernels:
        by_name[e.name].append(e.time_range.elapsed_us())
    by_family: Dict[str, float] = defaultdict(float)
    for name, times in by_name.items():
        by_family[family(name)] += sum(times) / 1e3 / args.steps

    pred = AffordancePredictor(model, DepthNorm(), (hw, hw), seed=0)
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (args.frame_hw, args.frame_hw, 3), np.uint8)
              for _ in range(args.predict_n)]
    langs = [ds[i]["lang"] for i in range(args.predict_n)]

    def predict():
        return pred.predict_batch(frames, langs)

    _wall_ms(predict, args.warmup)
    pwall = _wall_ms(predict, args.steps)
    pbusy_ms, pkernels, _ = _profiled(predict, args.steps)
    wall_ms, pwall_ms = statistics.median(wall), statistics.median(pwall)
    summary = {
        "card": card, "batch": bs, "frame_hw": args.frame_hw, "input_hw": hw,
        "step_wall_ms": wall_ms, "step_wall_spread_ms": [min(wall), max(wall)],
        "step_device_busy_ms": busy_ms, "step_idle_share": 1 - busy_ms / wall_ms,
        "step_device_activities": len(kernels) / args.steps,
        "by_family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
        "predict_n": args.predict_n, "predict_wall_ms": pwall_ms,
        "predict_wall_spread_ms": [min(pwall), max(pwall)], "predict_device_busy_ms": pbusy_ms,
        "trainable_params": sum(p.numel() for p in model.parameters() if p.requires_grad),
        "params": sum(p.numel() for p in model.parameters()),
    }
    print(f"card: {card}; torch {torch.__version__}")
    print(f"affordance train step, batch {bs} of {args.frame_hw}px frames at {hw}px: wall "
          f"{wall_ms:.3f} ms (median of {args.steps}, spread {min(wall):.3f}-{max(wall):.3f}), "
          f"device busy {busy_ms:.3f} ms, idle share {100 * summary['step_idle_share']:.1f}%, "
          f"{summary['step_device_activities']:.0f} device activities")
    print("device time per step by kernel family:")
    for fam, ms in summary["by_family_ms"].items():
        print(f"  {fam:<16} {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%")
    print("top kernels by device time per step:")
    for name, times in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        print(f"  {sum(times) / 1e3 / args.steps:8.3f} ms  x{len(times) // args.steps:<5d} {name[:100]}")
    print(f"prediction of {args.predict_n} frames: wall {pwall_ms:.3f} ms (spread "
          f"{min(pwall):.3f}-{max(pwall):.3f}), device busy {pbusy_ms:.3f} ms, "
          f"{len(pkernels) / args.steps:.0f} device activities")
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
