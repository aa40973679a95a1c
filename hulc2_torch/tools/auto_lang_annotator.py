"""Automatic language annotation of play data (``hulc2_tpu/tools/auto_lang_annotator.py``).

    python -m hulc2_torch.tools.auto_lang_annotator DATA_DIR [--lang-model DIR] [--device cpu]
        [--relabel [--resample] [--dst-folder F]] [--stats] [--window 64] [--stride 16]

The port's copy: ``detect_task_windows``, ``annotate_dataset`` (which takes
its embedding function explicitly), ``relabel_dataset`` (the reference's
relabel_with_new_lang_model.py), ``dataset_task_statistics`` (its
dataset_task_statistics.py), ``hash_embed`` and the
``require_stub_embeddings_ok`` gate, numpy only. ``--lang-model`` embeds with
``models.language.SBertEncoder`` (a local HuggingFace directory), on the card
unless ``--device cpu``; without it the CLI falls back to ``hash_embed``
behind the gate, as the JAX package's does. Other encoders reach
``relabel_dataset`` through its ``embed_fn``.

Counterpart of the reference's annotator pipeline
(reference: hulc2/utils/automatic_lang_annotator_mp.py:29-120,
conf/lang_ann.yaml): scan play episodes for windows where the task oracle
detects a completed task (here directly from the stored ``scene_obs`` vectors,
no simulator replay), sample a sentence from the annotation bank, embed it,
and write ``auto_lang_ann.npy`` + ``embeddings.npy`` in the format the
language dataset and evaluation consume (npz_dataset.py:145-194,
evaluation/utils.py:88-96).
"""
from __future__ import annotations

import argparse
import hashlib
import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from hulc2_torch.data.episode_index import load_ep_start_end_ids
from hulc2_torch.data.frame_store import NpzFrameStore
from hulc2_torch.envs.task_oracle import SceneObsTaskOracle
from hulc2_torch.evaluation.tasks import TASK_NAMES
from hulc2_torch.tools.annotations import VALIDATION_BANK, sample_annotation

logger = logging.getLogger(__name__)


def detect_task_windows(
    store: NpzFrameStore,
    ep_ids: np.ndarray,
    window: int = 64,
    stride: int = 16,
    tasks: Sequence[str] = TASK_NAMES,
    align_end: bool = True,
    tail: int = 8,
) -> List[dict]:
    """Slide a window over each episode; keep windows where exactly ONE task
    completed (unambiguous annotation, like the reference's oracle check).

    ``align_end`` (default): refine each hit to the EARLIEST frame where the
    oracle fires and re-anchor the window to end ``tail`` frames after it,
    the reference annotator's end-at-completion convention
    (automatic_lang_annotator_mp.py:78-97). Otherwise sub-windows sampled from
    the tail of the range would hold only the post-task retreat yet carry the
    task's sentence. Near-duplicate refinements of the same completion event
    (overlapping slide positions) are collapsed.

    The lookback that re-anchors a hit's start tries starts from ``window``
    frames before its end down to ``min(27, window // 2)`` frames, every
    ``min(6, window // 8)`` frames: 27 and 6 at the default window, as in the
    JAX package, whose fixed bounds leave that range empty, and so drop
    every hit, at a window of 27 frames or less."""
    if window < 8:
        raise ValueError(f"window {window}: task windows need at least 8 frames")
    shortest, lookback_step = min(27, window // 2), min(6, window // 8)
    oracle = SceneObsTaskOracle()
    hits = []
    for start, end in ep_ids:
        start, end = int(start), int(end)
        last_end: Dict[str, int] = {}  # task -> last aligned end kept
        for s in range(start, end - window + 1, stride):
            info_a = {"scene_obs": store.load_frame(s)["scene_obs"]}
            info_b = {"scene_obs": store.load_frame(s + window - 1)["scene_obs"]}
            done = oracle.get_task_info_for_set(info_a, info_b, tasks)
            if len(done) != 1:
                continue
            task = next(iter(done))
            if not align_end:
                hits.append({"task": task, "indx": (s, s + window - 1)})
                continue
            # earliest f in (s, s+window-1] with oracle(s -> f) firing
            lo, hi = s + 1, s + window - 1
            while lo < hi:
                mid = (lo + hi) // 2
                dm = oracle.get_task_info_for_set(
                    info_a, {"scene_obs": store.load_frame(mid)["scene_obs"]}, [task])
                if task in dm:
                    hi = mid
                else:
                    lo = mid + 1
            w_end = min(end, lo + tail)
            if task in last_end and abs(w_end - last_end[task]) <= window // 2:
                continue  # same completion event seen from an earlier slide
            # longest unambiguous lookback: shrink the start until exactly
            # this one task completes in range rather than dropping the hit
            db = {"scene_obs": store.load_frame(w_end)["scene_obs"]}
            for w_start in range(max(start, w_end - window + 1), w_end - shortest + 1,
                                 lookback_step):
                da = {"scene_obs": store.load_frame(w_start)["scene_obs"]}
                if oracle.get_task_info_for_set(da, db, tasks) == {task}:
                    last_end[task] = w_end
                    hits.append({"task": task, "indx": (w_start, w_end)})
                    break
    return hits


def annotate_dataset(
    data_dir,
    embed_fn: Union[str, Callable[[List[str]], np.ndarray]],
    lang_folder: str = "lang_annotations",
    window: int = 64,
    stride: int = 16,
    seed: int = 0,
    with_embeddings_lookup: bool = True,
    canonical: bool = False,
    holdout_k: int = 0,
    align_end: bool = True,
) -> dict:
    """Write <data_dir>/<lang_folder>/auto_lang_ann.npy (+ embeddings.npy).

    ``embed_fn="tokens"`` stores CLIP-BPE token ids (int32) as the "emb"
    field, for models with an in-graph text tower; otherwise ``embed_fn``
    maps sentences to float embeddings. ``holdout_k`` excludes the last K
    paraphrases of every task from sampling (``heldout_annotations``).
    Validation splits (and ``canonical``) use the one phrasing per task of
    ``VALIDATION_BANK``. ``align_end=False`` keeps every window in which
    exactly one task completes, unaligned (``detect_task_windows``)."""
    data_dir = Path(data_dir)
    split = data_dir.name if data_dir.name in ("training", "validation") else "training"
    ep_ids = load_ep_start_end_ids(data_dir, split)
    store = NpzFrameStore(data_dir, ["scene_obs"])
    hits = detect_task_windows(store, ep_ids, window, stride, align_end=align_end)

    rng = np.random.default_rng(seed)
    anns = [sample_annotation(h["task"], rng, validation=canonical or split == "validation",
                              holdout_k=holdout_k)
            for h in hits]
    tasks = [h["task"] for h in hits]
    if embed_fn == "tokens":
        from hulc2_torch.utils.clip_tokenizer import tokenize

        embed_fn = lambda ss: tokenize(ss).astype(np.int32)  # noqa: E731
        embs = embed_fn(anns)[:, None, :]  # (N, 1, L) int32
    else:
        embs = np.asarray(embed_fn(anns), np.float32)[:, None, :]  # (N, 1, E)

    lang_data = {
        "language": {"ann": anns, "task": tasks, "emb": embs},
        "info": {"episodes": [], "indx": [h["indx"] for h in hits]},
    }
    out = data_dir / lang_folder
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "auto_lang_ann.npy", lang_data)

    if with_embeddings_lookup:
        # canonical validation sentence per task -> embedding (the evaluation
        # lookup format); token-mode tables stay int32
        emb_lookup = {t: {"ann": [s], "emb": _keep_dtype(embed_fn([s]))}
                      for t, s in ((t, VALIDATION_BANK[t]) for t in TASK_NAMES)}
        np.save(out / "embeddings.npy", emb_lookup)
    return lang_data


def _keep_dtype(a) -> np.ndarray:
    a = np.asarray(a)
    return a if np.issubdtype(a.dtype, np.integer) else a.astype(np.float32)


def hash_embed(sentences: List[str], dim: int = 384) -> np.ndarray:
    """Deterministic stand-in embedding (a per-sentence seeded gaussian) for
    pipelines without a language tower. Distinct sentences map to distinct,
    reproducible vectors: enough for pipeline tests, NOT a semantic
    embedding."""
    out = np.empty((len(sentences), dim), np.float32)
    for i, s in enumerate(sentences):
        # digest of the WHOLE sentence: a prefix-seeded variant collides
        # sentences that share their start
        h = hashlib.blake2b(s.encode(), digest_size=8).digest()
        rng = np.random.default_rng(int.from_bytes(h, "little"))
        out[i] = rng.standard_normal(dim).astype(np.float32)
    return out


def require_stub_embeddings_ok(context: str) -> None:
    """Refuse an implicit fall-back to ``hash_embed``: metrics computed from
    stub embeddings are noise that looks like signal. A call site that would
    fall back without being asked passes through this gate, which lets it on
    only with ``HULC2_ALLOW_STUB_EMBEDDINGS`` set to 1, true or yes
    (``hulc2_tpu/tools/auto_lang_annotator.py:232-247``)."""
    import os

    if os.environ.get("HULC2_ALLOW_STUB_EMBEDDINGS", "") not in ("1", "true", "yes"):
        raise RuntimeError(
            f"{context}: no real language embeddings available, and stub hash "
            "embeddings were not explicitly allowed. Success rates computed "
            "from stub embeddings are meaningless. Provide an embeddings "
            "table (embeddings.npy / --lang-model), or set "
            "HULC2_ALLOW_STUB_EMBEDDINGS=1 to proceed knowingly (tests/smoke).")


def relabel_dataset(
    data_dir,
    src_folder: str = "lang_annotations",
    dst_folder: str = "lang_annotations_relabeled",
    embed_fn: Optional[Callable[[List[str]], np.ndarray]] = None,
    resample: bool = False,
    seed: int = 0,
) -> dict:
    """Embed an existing ``auto_lang_ann.npy`` anew, and with ``resample``
    draw its sentences anew from the bank, without replaying the data
    (reference: hulc2/utils/relabel_with_new_lang_model.py:12-21). Writes
    ``<data_dir>/<dst_folder>/auto_lang_ann.npy`` and ``embeddings.npy``
    (each task's canonical sentence). Without ``embed_fn``, ``hash_embed``
    behind ``require_stub_embeddings_ok``'s gate."""
    data_dir = Path(data_dir)
    split = data_dir.name if data_dir.name in ("training", "validation") else "training"
    src = np.load(data_dir / src_folder / "auto_lang_ann.npy", allow_pickle=True).item()
    tasks = list(src["language"]["task"])
    if resample:
        rng = np.random.default_rng(seed)
        anns = [sample_annotation(t, rng, validation=split == "validation") for t in tasks]
    else:
        anns = list(src["language"]["ann"])
    if embed_fn is None:
        require_stub_embeddings_ok("relabel_dataset")
        embed_fn = hash_embed
    embs = np.asarray(embed_fn(anns), np.float32)[:, None, :]
    lang_data = {
        "language": {"ann": anns, "task": tasks, "emb": embs},
        "info": dict(src["info"]),
    }
    out = data_dir / dst_folder
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "auto_lang_ann.npy", lang_data)
    emb_lookup = {
        t: {"ann": [s], "emb": np.asarray(embed_fn([s]), np.float32)}
        for t, s in ((t, VALIDATION_BANK[t]) for t in TASK_NAMES)
    }
    np.save(out / "embeddings.npy", emb_lookup)
    return lang_data


def dataset_task_statistics(data_dir, window: int = 64, stride: int = 16) -> Dict[str, int]:
    """Windows per task that the scene-obs oracle finds in a play dataset,
    most frequent first (reference: hulc2/utils/dataset_task_statistics.py:12-25,
    which replays each episode in the simulator)."""
    data_dir = Path(data_dir)
    split = data_dir.name if data_dir.name in ("training", "validation") else "training"
    ep_ids = load_ep_start_end_ids(data_dir, split)
    store = NpzFrameStore(data_dir, ["scene_obs"])
    hits = detect_task_windows(store, ep_ids, window, stride)
    counts: Dict[str, int] = {}
    for h in hits:
        counts[h["task"]] = counts.get(h["task"], 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("data_dir")
    p.add_argument("--lang-folder", default="lang_annotations")
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--stride", type=int, default=16)
    p.add_argument("--lang-model", default=None,
                   help="a local sentence-transformers directory; hash stub if omitted")
    p.add_argument("--device", default=None, help="--lang-model's device (default: the card)")
    p.add_argument("--relabel", action="store_true",
                   help="embed the --lang-folder annotations anew into --dst-folder")
    p.add_argument("--dst-folder", default="lang_annotations_relabeled")
    p.add_argument("--resample", action="store_true",
                   help="with --relabel: draw the sentences anew from the bank")
    p.add_argument("--stats", action="store_true", help="only print the windows per task")
    args = p.parse_args(argv)
    if args.stats:
        for task, n in dataset_task_statistics(args.data_dir, args.window, args.stride).items():
            print(f"{task}: {n}")
        return
    embed_fn = None
    if args.lang_model:
        from hulc2_torch.models.language import SBertEncoder

        embed_fn = SBertEncoder(args.lang_model, device=args.device)
    if args.relabel:
        relabel_dataset(args.data_dir, args.lang_folder, args.dst_folder, embed_fn,
                        resample=args.resample)
        return
    if embed_fn is None:
        require_stub_embeddings_ok("auto_lang_annotator")
        embed_fn = hash_embed
    annotate_dataset(args.data_dir, embed_fn, args.lang_folder, args.window, args.stride)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
