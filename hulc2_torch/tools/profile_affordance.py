"""Device-time breakdown of the affordance detector's train step and prediction.

    python -m hulc2_torch.tools.profile_affordance [--steps 10] [--warmup 3] \\
        [aff_detection=<group>] [aff_detection.compute_dtype=bfloat16] [key=value ...]

Builds the detector of ``configs/affordance.py`` (``rn18_tokens_pixel``
unless ``aff_detection=<group>`` names another; the bf16 decoder with
``aff_detection.compute_dtype=bfloat16``) at full width on the card and
times, on synthetic uint8 frames of ``--frame-hw`` px (the expert dataset's
96 by default), with the group's language input and labels:

- the train step of ``train_affordance`` (device resize to 224, crop of image
  and label, forward with the decoder's BatchNorm on batch statistics, loss,
  backward, Adam) at the config's batch size: wall time per step (host
  clock, each step ending in a device synchronise), device busy time (union
  of the kernels' intervals under ``torch.profiler``), the idle share, and
  device time by kernel family with the convolutions' share of the busy
  time;
- the hierarchical eval's prediction (``AffordancePredictor.predict_batch``)
  of ``--predict-n`` frames: wall time per call (frames copied to the card,
  one forward, results back on the host) and device busy time.

Prints one JSON line with the numbers last. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hulc2_torch.tools import profiling

CONV = "conv (cuDNN)"  # tools/profiling.FAMILIES' convolutions


def synthetic_train_step(cfg: dict, dev: torch.device, frame_hw: int = 96, n_batches: int = 4,
                         seed: int = 1, dtype: torch.dtype = torch.float32):
    """(model, step): the detector of ``cfg`` on ``dev`` and a callable that
    runs ``train_affordance``'s train step on the next of ``n_batches``
    synthetic batches of ``frame_hw`` px frames (labels and masks at the
    model's input size) with its crop offsets, drawn on the host from a
    generator seeded 0: the same batches, offsets and weights on any
    device. ``dtype`` is the parameters' and the float inputs' precision
    (float64 gives a reference for the float32 step)."""
    from hulc2_torch.affordance.train_affordance import (
        SyntheticAffordanceDataset,
        build_detector,
        input_hw,
        label_type,
        make_aff_train_step,
        to_device,
    )
    from hulc2_torch.data.loader import collate
    from hulc2_torch.train.optim import make_optimizer

    aff, bs, pad = cfg["aff_detection"], cfg["batch_size"], cfg["rand_shift_pad"]
    hw, labels = input_hw(aff), label_type(aff)
    model = build_detector(aff, cfg["seed"]).to(dev, dtype)
    opt = make_optimizer(model.parameters(), aff["optimizer"])
    step = make_aff_train_step(model, opt, aff["loss_weights"], hw, pad, labels)
    ds = SyntheticAffordanceDataset(n_batches * bs, frame_hw, aff["lang_embed_dim"], seed,
                                    labels, aff.get("text_tower", False))
    batches = [{k: v.to(dtype) if v.is_floating_point() else v
                for k, v in to_device(collate([ds[b * bs + i] for i in range(bs)]), dev).items()}
               for b in range(n_batches)]
    nearest = torch.arange(hw, device=dev) * frame_hw // hw
    for b in batches:  # labels at the model's input size
        b["px"] = (b["px"] * hw // frame_hw).int()
        if "mask" in b:
            b["mask"] = b["mask"][:, nearest][:, :, nearest]
    g = torch.Generator().manual_seed(0)
    offsets = [torch.randint(0, 2 * pad + 1, (bs, 2), generator=g, dtype=torch.int32).to(dev)
               for _ in range(n_batches)]
    calls = iter(range(1 << 30))

    def train_step():
        i = next(calls) % n_batches
        return step(batches[i], offsets[i])

    return model, train_step


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from hulc2_torch.affordance.depth_heads import DepthNorm
    from hulc2_torch.affordance.detector import AffordancePredictor
    from hulc2_torch.affordance.train_affordance import SyntheticAffordanceDataset, input_hw
    from hulc2_torch.configs.affordance import affordance_config
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
    card = profiling.card_line()
    dev = torch.device("cuda")
    set_precision_flags()
    cfg = affordance_config(args.overrides)
    aff, bs = cfg["aff_detection"], cfg["batch_size"]
    hw = input_hw(aff)
    model, train_step = synthetic_train_step(cfg, dev, args.frame_hw)
    profiling.wall_ms(train_step, args.warmup)
    wall = profiling.wall_ms(train_step, args.steps)
    stepped = profiling.profiled(train_step, args.steps)
    busy_ms, b = stepped.busy_ms, profiling.breakdown(stepped.activities, args.steps)

    pred = AffordancePredictor(model, DepthNorm(), (hw, hw), seed=0)
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (args.frame_hw, args.frame_hw, 3), np.uint8)
              for _ in range(args.predict_n)]
    ds = SyntheticAffordanceDataset(args.predict_n, args.frame_hw, aff["lang_embed_dim"], 3,
                                    lang_tokens=aff.get("text_tower", False))
    langs = [ds[i]["lang"] for i in range(args.predict_n)]

    def predict():
        return pred.predict_batch(frames, langs)

    profiling.wall_ms(predict, args.warmup)
    pwall = profiling.wall_ms(predict, args.steps)
    predicted = profiling.profiled(predict, args.steps)
    pbusy_ms = predicted.busy_ms
    wall_ms, pwall_ms = statistics.median(wall), statistics.median(pwall)
    conv_ms = b.family_ms.get(CONV, 0.0)
    summary = {
        "card": card, "encoder": aff["encoder_name"], "overrides": list(args.overrides),
        "compute_dtype": aff.get("compute_dtype") or "float32",
        "batch": bs, "frame_hw": args.frame_hw, "input_hw": hw,
        "step_wall_ms": wall_ms, "step_wall_spread_ms": [min(wall), max(wall)],
        "step_device_busy_ms": busy_ms, "step_idle_share": 1 - busy_ms / wall_ms,
        "step_device_activities": len(stepped.activities) / args.steps,
        "by_family_ms": b.family_ms,
        "conv_share": conv_ms / busy_ms,
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
    print(f"device time per step by kernel family (convolutions {100 * conv_ms / busy_ms:.1f}% "
          f"of the busy time):")
    print("\n".join(profiling.family_rows(b, busy_ms)))
    print("top kernels by device time per step:")
    print("\n".join(profiling.top_rows(b, args.steps, 12)))
    print(f"prediction of {args.predict_n} frames: wall {pwall_ms:.3f} ms (spread "
          f"{min(pwall):.3f}-{max(pwall):.3f}), device busy {pbusy_ms:.3f} ms, "
          f"{len(predicted.activities) / args.steps:.0f} device activities")
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
