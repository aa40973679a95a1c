"""Human annotations: the LangAnnotationApp's SQLite file -> auto_lang_ann.npy.

    python -m hulc2_torch.tools.annotation_db DB --out-dir OUT [--frequency-divisor 2]

The port's copy of ``hulc2_tpu/tools/annotation_db.py`` (reference:
hulc2/scripts/get_annotations.py:15-45). The table is ``annotations(seq_name
TEXT, annotation TEXT [, task TEXT])``, where ``seq_name`` ends in the frame
range as ``...-<start>-<end>``. The sentences are embedded with
``embed_fn``; without one, with ``hash_embed`` behind
``require_stub_embeddings_ok``'s gate. numpy and sqlite3 only.
"""
from __future__ import annotations

import argparse
import logging
import re
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def read_annotation_db(db_path, table: str = "annotations") -> List[dict]:
    """{"indx": (start, end), "ann", "task"} per row whose ``seq_name`` ends
    in a frame range; other rows are skipped."""
    import sqlite3

    con = sqlite3.connect(db_path)
    try:
        cols = [r[1] for r in con.execute(f"PRAGMA table_info({table})")]
        rows = con.execute(f"SELECT * FROM {table}").fetchall()
    finally:
        con.close()
    out = []
    for row in rows:
        rec = dict(zip(cols, row))
        m = re.search(r"(\d+)[-_](\d+)$", str(rec.get("seq_name", "")))
        if not m:
            continue
        out.append(
            {
                "indx": (int(m.group(1)), int(m.group(2))),
                "ann": str(rec.get("annotation", "")).strip(),
                "task": str(rec.get("task", "unknown")),
            }
        )
    return out


def export_auto_lang_ann(
    db_path,
    out_dir,
    embed_fn: Optional[Callable[[List[str]], np.ndarray]] = None,
    frequency_divisor: int = 1,
) -> dict:
    """Write auto_lang_ann.npy in the dataset format; ``frequency_divisor=2``
    produces the 15Hz variant of 30Hz recordings (frame ids halved)."""
    records = read_annotation_db(db_path)
    if not records:
        raise ValueError(f"no parsable annotations in {db_path}")
    if embed_fn is None:
        from hulc2_torch.tools.auto_lang_annotator import hash_embed, require_stub_embeddings_ok

        require_stub_embeddings_ok("annotation_db export")
        embed_fn = hash_embed
    anns = [r["ann"] for r in records]
    embs = np.asarray(embed_fn(anns), np.float32)[:, None, :]
    data = {
        "language": {"ann": anns, "task": [r["task"] for r in records], "emb": embs},
        "info": {
            "episodes": [],
            "indx": [
                (r["indx"][0] // frequency_divisor, r["indx"][1] // frequency_divisor)
                for r in records
            ],
        },
    }
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "auto_lang_ann.npy", data)
    logger.info("wrote %d annotations to %s", len(records), out_dir)
    return data


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("db_path")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--frequency-divisor", type=int, default=1, help="2 for 30Hz->15Hz ids")
    args = p.parse_args(argv)
    export_auto_lang_ann(args.db_path, args.out_dir, frequency_divisor=args.frequency_divisor)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
