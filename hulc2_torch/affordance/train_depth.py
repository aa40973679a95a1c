"""Depth-only training of the affordance detector (``hulc2_tpu/affordance/train_depth.py``).

    python -m hulc2_torch.affordance.train_depth --run-dir RUN \\
        aff_detection.dataset.data_dir=AFF_DATA [--max-epochs N] [--max-steps K] \\
        [--synthetic] [--device cuda|cpu] [key=value ...]

The same detector and trainer as ``train_affordance``, with the affordance
loss's weight at 0, the depth loss's at 1 and the encoder trainable, so the
depth head's features are learned end to end; the remaining overrides
follow these and may change them. A group named on the command line
(``aff_detection=<group>``) is selected before these settings: JAX's CLI
selects it after them, and the group's own loss weights and freezing then
replace the depth-only ones. Logs the depth NLL and the absolute depth error
in metres. Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

from hulc2_torch.affordance import train_affordance

DEPTH_ONLY = ("aff_detection.loss_weights.aff=0.0", "aff_detection.loss_weights.depth=1.0",
              "aff_detection.freeze_encoder=false")


def main(argv: Optional[Sequence[str]] = None) -> train_affordance.AffTrainResult:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--run-dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    args = p.parse_args(argv)
    groups = [ov for ov in args.overrides if ov.startswith("aff_detection=")]
    rest = [ov for ov in args.overrides if ov not in groups]
    return train_affordance.train([*groups, *DEPTH_ONLY, *rest], args.max_epochs, args.max_steps,
                                  args.synthetic, args.run_dir, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    main(sys.argv[1:])
