"""Automatic language annotation of play data (``hulc2_tpu/tools/auto_lang_annotator.py``).

The port's numpy copy of ``detect_task_windows``, ``annotate_dataset`` and
``hash_embed``, the part the dataset generator runs; relabelling, the task
statistics CLI and the external sentence encoders are not ported, and
``annotate_dataset`` takes its embedding function explicitly.

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

import hashlib
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Union

import numpy as np

from hulc2_torch.data.episode_index import load_ep_start_end_ids
from hulc2_torch.data.frame_store import NpzFrameStore
from hulc2_torch.envs.task_oracle import SceneObsTaskOracle
from hulc2_torch.evaluation.tasks import TASK_NAMES
from hulc2_torch.tools.annotations import VALIDATION_BANK, sample_annotation


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
) -> dict:
    """Write <data_dir>/<lang_folder>/auto_lang_ann.npy (+ embeddings.npy).

    ``embed_fn="tokens"`` stores CLIP-BPE token ids (int32) as the "emb"
    field, for models with an in-graph text tower; otherwise ``embed_fn``
    maps sentences to float embeddings. ``holdout_k`` excludes the last K
    paraphrases of every task from sampling (``heldout_annotations``).
    Validation splits (and ``canonical``) use the one phrasing per task of
    ``VALIDATION_BANK``."""
    data_dir = Path(data_dir)
    split = data_dir.name if data_dir.name in ("training", "validation") else "training"
    ep_ids = load_ep_start_end_ids(data_dir, split)
    store = NpzFrameStore(data_dir, ["scene_obs"])
    hits = detect_task_windows(store, ep_ids, window, stride)

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
