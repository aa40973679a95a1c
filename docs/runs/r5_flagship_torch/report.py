"""Stage checks and the report of the round-5 flagship run through the port.

    python docs/runs/r5_flagship_torch/report.py dataset DATA   # stage 1's counts
    python docs/runs/r5_flagship_torch/report.py labels AFF_DATA  # stage 2's
    python docs/runs/r5_flagship_torch/report.py report OUT       # the tables

``dataset`` and ``labels`` print their counts as JSON and exit 1 when they
differ from the r5 run's (``docs/runs/r5_flagship/README.md``): 263,393
training frames, 10,065 language windows, 22,843 training labels. ``report``
reads what ``run.sh`` wrote to OUT and prints markdown: each stage's wall
time and rate, the card's utilisation and the host's RAM over it, the val
metrics per epoch and the scores beside the r5 run's. Numpy and the standard
library only.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

R5 = Path(__file__).resolve().parent.parent / "r5_flagship"
R5_FRAMES, R5_LANG_WINDOWS, R5_LABELS = 263_393, 10_065, 22_843


def dataset_counts(data: Path) -> dict:
    out = {}
    for split in ("training", "validation"):
        d = data / split
        ids = np.load(d / "ep_start_end_ids.npy")
        ann = np.load(d / "lang_annotations" / "auto_lang_ann.npy", allow_pickle=True).item()
        out[split] = {"episodes": len(ids), "frames": int(sum(e - s + 1 for s, e in ids)),
                      "lang_windows": len(ann["language"]["ann"])}
    return out


def label_counts(aff: Path) -> dict:
    info = json.loads((aff / "episodes_split.json").read_text())
    out = {split: sum(len(v["static_cam"]) for v in info[split].values())
           for split in ("training", "validation")}
    out["depth_norm"] = info["norm_values"]["depth"]["static_cam"]
    return out


def _jsonl(path: Path) -> list:
    return [json.loads(l) for l in path.read_text().splitlines() if l.strip()] if path.is_file() else []


def _monitor(out: Path):
    rows = []
    p = out / "monitor.csv"
    if p.is_file():
        for line in p.read_text().splitlines()[1:]:
            f = line.split(",")
            try:
                rows.append([float(x) for x in f])
            except ValueError:
                continue
    return np.asarray(rows).reshape(-1, 5)


def _val_lines(lines: list) -> list:
    return [l for l in lines if any(k.startswith("val/") for k in l)]


def _fmt(x, nd=4):
    return "—" if x is None else (f"{x:.{nd}f}" if isinstance(x, float) else str(x))


def report(out: Path) -> str:
    md = []
    card = (out / "card.txt").read_text().strip() if (out / "card.txt").is_file() else "unknown card"
    md.append(f"Card: {card}\n")
    timings = _jsonl(out / "stage_timings.jsonl")
    mon = _monitor(out)
    counts = json.loads((out / "dataset_counts.json").read_text()) if (out / "dataset_counts.json").is_file() else None
    labels = json.loads((out / "label_counts.json").read_text()) if (out / "label_counts.json").is_file() else None
    pol = _jsonl(out / "policy_metrics.jsonl")
    aff = _jsonl(out / "aff_metrics.jsonl")
    evals = {s: (json.loads((out / n / "eval_diagnostics.json").read_text())
                 if (out / n / "eval_diagnostics.json").is_file() else None)
             for s, n in (("5", "eval_1000"), ("6", "eval_1000_paraphrase"))}
    partial = out / "eval_random.partial_results.json"
    partial = json.loads(partial.read_text()) if partial.is_file() else None

    md.append("| Stage | Wall time | Work | Rate | Card utilisation (mean of 15 s samples) | Host RAM used, peak |")
    md.append("|---|---|---|---|---|---|")
    for t in timings:
        n, sec = str(t["stage"]), t["seconds"]
        work, rate = "—", "—"
        if n == "1" and counts:
            fr = counts["training"]["frames"] + counts["validation"]["frames"]
            work, rate = f"{fr:,} frames", f"{fr / sec:.1f} frames/s"
        elif n == "2" and labels:
            lb = labels["training"] + labels["validation"]
            work, rate = f"{lb:,} labels", f"{lb / sec:.1f} labels/s"
        elif n == "3" and pol:
            # the trainer's perf/ line of each epoch: its train loop's time
            epochs = [l for l in pol if "perf/epoch_time_s" in l]
            steps = max(l["step"] for l in pol)
            launches = sum(l.get("perf/kernel_launches_shift_normalize", 0) for l in epochs)
            work = f"{steps:,} steps, {launches:,.0f} `shift_normalize` launches"
            if epochs:
                per = np.diff([0] + [l["step"] for l in epochs])
                ms = 1e3 * np.asarray([l["perf/epoch_time_s"] for l in epochs]) / per
                wait = 1e3 * np.asarray([l["perf/prefetch_wait_s"] for l in epochs]) / per
                rate = (f"{ms.min():.2f}-{ms.max():.2f} ms a step over an epoch's train loop "
                        f"(mean {ms.mean():.2f}); prefetch wait {wait.mean():.3f} ms a step")
        elif n == "4" and aff:
            train = [l for l in aff if any(k.startswith("train/") for k in l)]
            steps = max(l["step"] for l in aff)
            work = f"{steps:,} steps"
            if len(train) > 1:
                ms = 1e3 * (train[-1]["time"] - train[0]["time"]) / (train[-1]["step"] - train[0]["step"])
                rate = f"{ms:.2f} ms a step between the first and last logged step (val included)"
        elif t["name"] == "eval_random" and partial:
            work = f"{partial['completed_chains']:,} of 1000 chains (random weights)"
            rate = f"{partial['env_steps_per_s']:.1f} env-steps/s over {partial['elapsed_s']:.1f} s"
        elif n in evals and evals[n]:
            e = evals[n]
            launches = e.get("kernel_launches", {}).get("shift_normalize", 0)
            work = f"{e['total_env_steps']:,} env steps, {launches:,} `shift_normalize` launches"
            rate = f"{e['total_env_steps'] / e['wall_clock_s']:.1f} env-steps/s over the rollout ({e['wall_clock_s']:.1f} s)"
        util = ram = "—"
        if len(mon):
            sel = mon[(mon[:, 0] >= t["start"]) & (mon[:, 0] <= t["end"])]
            if len(sel):
                util = f"{sel[:, 1].mean():.1f}% ({len(sel)} samples)"
                ram = f"{sel[:, 4].max() / 1024:.1f} GiB"
        cut = " (cut)" if t.get("cut") else ("" if t["rc"] == 0 else f" (rc {t['rc']})")
        md.append(f"| {n} {t['name']}{cut} | {sec:.1f} s | {work} | {rate} | {util} | {ram} |")

    if counts or labels:
        md.append("\n| Check | This run | r5 |\n|---|---|---|")
        if counts:
            md.append(f"| training frames | {counts['training']['frames']:,} | {R5_FRAMES:,} |")
            md.append(f"| training language windows | {counts['training']['lang_windows']:,} | {R5_LANG_WINDOWS:,} |")
            md.append(f"| validation frames, windows | {counts['validation']['frames']:,}, {counts['validation']['lang_windows']:,} | — |")
        if labels:
            md.append(f"| training labels | {labels['training']:,} | {R5_LABELS:,} |")
            r5n = json.loads((R5 / "aff_config.json").read_text())["depth_norm"]
            md.append(f"| label depth mean, std | {labels['depth_norm']['mean']!r}, {labels['depth_norm']['std']!r} | {r5n['mean']!r}, {r5n['std']!r} |")

    for title, mine, ref_name, keys in (
            ("Policy val per epoch", pol, "policy_val_metrics.jsonl",
             ("val/lang_total_mae_pp", "val/vis_total_mae_pp", "val/lang_act_loss_pp",
              "val/vis_act_loss_pp", "val/val_pred_clip_loss")),
            ("Detector val per epoch", aff, "aff_val_metrics.jsonl",
             ("val/px_dist_err", "val/depth_err", "val/aff_loss", "val/total_loss"))):
        got, ref = _val_lines(mine), _jsonl(R5 / ref_name)
        if not got:
            continue
        md.append(f"\n{title} (this run / r5):\n")
        md.append("| Epoch | Step | " + " | ".join(k[4:] for k in keys) + " |")
        md.append("|---" * (len(keys) + 2) + "|")
        for i, g in enumerate(got):
            r = ref[i] if i < len(ref) else {}
            md.append(f"| {i + 1} | {g['step']:,} / {r.get('step', '—')} | " + " | ".join(
                f"{_fmt(g.get(k))} / {_fmt(r.get(k))}" for k in keys) + " |")

    for n, sub in (("5", ""), ("6", "paraphrase/")):
        e = evals[n]
        if not e:
            continue
        ref = json.loads((R5 / sub / "eval_diagnostics.json").read_text())
        mine_res = json.loads((out / ("eval_1000" if n == "5" else "eval_1000_paraphrase") / "results.json").read_text())["latest"]
        ref_res = json.loads((R5 / sub / "results.json").read_text())["latest"]
        md.append(f"\nStage {n} ({'held-out paraphrases' if n == '6' else 'canonical'}), this run / r5:\n")
        md.append("| avg_seq_len | SR@1 | SR@2 | SR@3 | SR@4 | SR@5 | env steps | predictions, approaches |")
        md.append("|---|---|---|---|---|---|---|---|")
        sr = lambda r, k: f"{100 * r['chain_sr'][k]:.1f}%"  # noqa: E731
        md.append(f"| {mine_res['avg_seq_len']} / {ref_res['avg_seq_len']} | " + " | ".join(
            f"{sr(mine_res, k)} / {sr(ref_res, k)}" for k in "12345") +
            f" | {e['total_env_steps']:,} / {ref['total_env_steps']:,} | "
            f"{e['hierarchical']['aff_predictions']:,}, {e['hierarchical']['approaches']:,} / "
            f"{ref['hierarchical']['aff_predictions']:,}, {ref['hierarchical']['approaches']:,} |")
        md.append(f"\nTimings (s, summed over cohorts): {e['timings_s']}\n")
        md.append("| Task | SR (attempts) this run | SR (attempts) r5 |\n|---|---|---|")
        for task in sorted(set(e["per_task"]) | set(ref["per_task"])):
            a, b = e["per_task"].get(task), ref["per_task"].get(task)
            f = lambda x: "—" if x is None else f"{x['sr']:.2f} ({x['attempts']})"  # noqa: E731
            md.append(f"| {task} | {f(a)} | {f(b)} |")
    return "\n".join(md)


def main(argv) -> int:
    cmd, path = argv[0], Path(argv[1])
    if cmd == "dataset":
        c = dataset_counts(path)
        print(json.dumps(c))
        return int((c["training"]["frames"], c["training"]["lang_windows"])
                   != (R5_FRAMES, R5_LANG_WINDOWS))
    if cmd == "labels":
        c = label_counts(path)
        print(json.dumps(c))
        return int(c["training"] != R5_LABELS)
    if cmd == "report":
        print(report(path))
        return 0
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
