"""The flagship policy configuration: the registry's ``cfg_low_level`` with
the round-5 flagship recipe's overrides.

``flagship_config(overrides)`` is ``compose("cfg_low_level",
FLAGSHIP_OVERRIDES + overrides)`` over the port's copy of the JAX package's
registry (``configs/policy.py``): the recipe of
``docs/runs/r5_flagship/policy_config.json``, with the caller's overrides
applied before the interpolations resolve, as the JAX package composes it.
``datamodule.root_data_dir`` names the dataset the trainer reads
(``python -m hulc2_torch.tools.make_expert_dataset`` writes one).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import hulc2_torch.configs.policy  # noqa: F401  (registers the groups)
from hulc2_torch.core.config import compose

FLAGSHIP_OVERRIDES = (
    "datamodule.device_store=true",
    "datamodule.transforms=rand_shift_96",
    "datamodule.load_lang_embeddings=false",
    "model/language_encoder=clip_scratch",
    "model.use_lang_task_auxiliary_loss=true",
)


def flagship_config(overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """The flagship config with dotted ``key=value`` overrides (values parsed
    as JSON where they parse), e.g. ``model.plan_proposal.hidden_size=64``."""
    return compose("cfg_low_level", list(FLAGSHIP_OVERRIDES) + list(overrides))
