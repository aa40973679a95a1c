"""Dataset viewers: play through recorded frames, or preview affordance labels
and a detector's predictions.

    python -m hulc2_torch.tools.visualize_dataset play DATA_DIR [--out OUT.mp4] [--show]
        [--limit 600]
    python -m hulc2_torch.tools.visualize_dataset affordance LABEL_DIR [--train-dir RUN]
        [--out-dir OUT] [--show] [-n 16] [--device cpu] [--no-images]

The port's copy of ``hulc2_tpu/tools/visualize_dataset.py`` (reference:
hulc2/utils/visualize_calvin_dataset.py, hulc2/affordance/test_affordance.py:27).
``play`` captions each frame (the gripper inset, its state and the active
annotation) and writes an mp4 with imageio. ``affordance`` marks each
validation label, and with ``--train-dir`` overlays the detector's heat map
and pixel (predicted on the card unless ``--device cpu``), writes
``sample_NNN.png`` with imageio and ``errors.json`` with the pixel and depth
errors. Every detector gets the hash embedding of the label's caption, as
in the JAX package, so a detector over token ids (``text_tower``) is
refused; ``--no-images`` writes ``errors.json`` alone (without cv2,
matplotlib and imageio). The label's marker is drawn at the frame's size
from the dataset's ``img_resize`` (224 px, as the JAX package's 224).
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from hulc2_torch.utils.img_utils import add_img_text, draw_marker, heatmap_overlay

logger = logging.getLogger(__name__)


def iter_play_frames(data_dir, start: Optional[int] = None, end: Optional[int] = None):
    from hulc2_torch.data.episode_index import load_ep_start_end_ids
    from hulc2_torch.data.frame_store import NpzFrameStore

    data_dir = Path(data_dir)
    split = data_dir.name if data_dir.name in ("training", "validation") else "training"
    ep_ids = load_ep_start_end_ids(data_dir, split)
    store = NpzFrameStore(data_dir, ["rgb_static", "rgb_gripper", "robot_obs", "rel_actions"])
    for s, e in ep_ids:
        s = max(int(s), start) if start is not None else int(s)
        e = min(int(e), end) if end is not None else int(e)
        for i in range(s, e + 1):
            yield i, store.load_frame(i)


def render_play_frame(idx: int, frame: dict, annotation: Optional[str] = None) -> np.ndarray:
    """The static frame (BGR) with the gripper camera inset at its top right
    and a caption bar."""
    import cv2

    img = frame["rgb_static"][:, :, ::-1].copy()
    if "rgb_gripper" in frame:
        g = cv2.resize(frame["rgb_gripper"][:, :, ::-1], (img.shape[1] // 3, img.shape[0] // 3))
        img[: g.shape[0], -g.shape[1]:] = g
    grip = float(frame["robot_obs"][-1])
    text = f"frame {idx}  gripper {'closed' if grip < 0 else 'open'}"
    if annotation:
        text += f"  |  {annotation}"
    return add_img_text(img, text)


def load_annotation_spans(data_dir, lang_folder: str = "lang_annotations") -> dict:
    """frame id -> the first annotation whose window holds it, from
    auto_lang_ann.npy; empty without one."""
    f = Path(data_dir) / lang_folder / "auto_lang_ann.npy"
    if not f.exists():
        return {}
    data = np.load(f, allow_pickle=True).item()
    spans = {}
    for (s, e), ann in zip(data["info"]["indx"], data["language"]["ann"]):
        for i in range(int(s), int(e) + 1):
            spans.setdefault(i, ann)
    return spans


def visualize_play(data_dir, out: Optional[str] = None, show: bool = False, fps: int = 15,
                   limit: int = 600) -> list:
    """The captioned RGB frames of up to ``limit`` frames; written to ``out``
    (an mp4) when given."""
    spans = load_annotation_spans(data_dir)
    frames = []
    for n, (idx, frame) in enumerate(iter_play_frames(data_dir)):
        img = render_play_frame(idx, frame, annotation=spans.get(idx))
        if show:
            import cv2

            cv2.imshow("dataset", img)
            cv2.waitKey(1)
        frames.append(img[:, :, ::-1])
        if n + 1 >= limit:
            break
    if out:
        import imageio

        imageio.mimwrite(out, frames, fps=fps, macro_block_size=1)
        logger.info("wrote %s (%d frames)", out, len(frames))
    return frames


def visualize_affordance(data_dir, train_dir: Optional[str] = None, out_dir: Optional[str] = None,
                         show: bool = False, n: int = 16, device=None,
                         images: bool = True) -> Optional[dict]:
    """Preview up to ``n`` validation labels of an affordance dataset, with a
    detector's predictions when ``train_dir`` is given; returns the
    ``errors.json`` summary (None without a detector)."""
    from hulc2_torch.affordance.dataset import AffordanceDataset
    from hulc2_torch.tools.auto_lang_annotator import hash_embed

    predictor, lang_dim = None, 384
    if train_dir:
        from hulc2_torch.core.checkpoint import load_run_config
        from hulc2_torch.evaluation.loading import load_affordance

        aff_cfg = load_run_config(train_dir)["aff_detection"]
        if aff_cfg.get("text_tower"):
            raise ValueError(
                f"{train_dir}: the detector reads token ids (text_tower); the preview feeds "
                "every detector the hash embedding of the caption, so it previews detectors "
                "over sentence embeddings only")
        lang_dim = aff_cfg["lang_embed_dim"]
        predictor = load_affordance(train_dir, device=device)
        logger.warning("predictions use stub hash embeddings of the captions: a qualitative "
                       "preview (a real eval supplies the model's own language embeddings)")
    ds = AffordanceDataset(data_dir, "validation",
                           lang_embedder=lambda s: hash_embed([s], dim=lang_dim)[0])

    out_dir = Path(out_dir or "aff_viz")
    out_dir.mkdir(parents=True, exist_ok=True)
    errors = []
    for i in range(min(n, len(ds))):
        s = ds[i]
        img = s["frame"].copy()
        px_gt = s["px"]  # (row, col) at the dataset's img_resize
        gt_xy = (int(px_gt[1] * img.shape[1] / ds.img_resize),
                 int(px_gt[0] * img.shape[0] / ds.img_resize))
        if images:
            img = draw_marker(img, gt_xy)
        caption = "gt label"
        if predictor is not None:
            pred = predictor.predict(s["frame"], s["lang"])
            if images:
                img = heatmap_overlay(img, pred["softmax"], alpha=0.5)
                img = draw_marker(img, pred["pixel"])
            caption = f"pred depth {pred.get('depth', 0):.3f}"
            err = {
                "sample": i,
                "px_error": float(np.hypot(pred["pixel"][0] - gt_xy[0], pred["pixel"][1] - gt_xy[1])),
            }
            # a label without a stored depth carries 0.0, which is no camera depth
            if "depth" in pred and float(s.get("depth", 0.0)) != 0.0:
                err["depth_error"] = abs(float(pred["depth"]) - float(s["depth"]))
            errors.append(err)
        if not images:
            continue
        img = add_img_text(img, caption)
        if show:
            import cv2

            cv2.imshow("affordance", img[:, :, ::-1])
            cv2.waitKey(0)
        else:
            import imageio

            imageio.imwrite(out_dir / f"sample_{i:03d}.png", img)
    summary = None
    if errors:
        summary = {
            "mean_px_error": float(np.mean([e["px_error"] for e in errors])),
            "median_px_error": float(np.median([e["px_error"] for e in errors])),
            "samples": errors,
        }
        d_errs = [e["depth_error"] for e in errors if "depth_error" in e]
        if d_errs:
            summary["mean_depth_error"] = float(np.mean(d_errs))
        (out_dir / "errors.json").write_text(json.dumps(summary, indent=2))
        logger.info("mean px error %.1f over %d samples", summary["mean_px_error"], len(errors))
    logger.info("affordance previews in %s", out_dir)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("play")
    v.add_argument("data_dir")
    v.add_argument("--out", default=None)
    v.add_argument("--show", action="store_true")
    v.add_argument("--limit", type=int, default=600)
    a = sub.add_parser("affordance")
    a.add_argument("data_dir")
    a.add_argument("--train-dir", default=None)
    a.add_argument("--out-dir", default=None)
    a.add_argument("--show", action="store_true")
    a.add_argument("-n", type=int, default=16)
    a.add_argument("--device", default=None, help="the detector's device (default: the card)")
    a.add_argument("--no-images", action="store_true",
                   help="write errors.json only (no cv2, matplotlib or imageio)")
    args = p.parse_args(argv)
    if args.cmd == "play":
        visualize_play(args.data_dir, args.out, args.show, limit=args.limit)
    else:
        visualize_affordance(args.data_dir, args.train_dir, args.out_dir, args.show, args.n,
                             device=args.device, images=not args.no_images)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
