"""The canonical instruction per CALVIN task (``VALIDATION_BANK``).

The port's copy of the validation half of ``hulc2_tpu/tools/annotations.py``:
the first phrasing of each task's paraphrase list, the sentence the
validation split and the evaluation goals use. The paraphrase bank itself
belongs to dataset tooling and is not ported.
"""
from __future__ import annotations

from typing import Dict

from hulc2_torch.evaluation.tasks import COLORS, TASK_NAMES


def build_validation_bank() -> Dict[str, str]:
    bank: Dict[str, str] = {}
    for verb in ("rotate", "push"):
        for c in COLORS:
            for d in ("right", "left"):
                bank[f"{verb}_{c}_block_{d}"] = f"{verb} the {c} block to the {d}"
    bank.update({
        "move_slider_left": "move the sliding door to the left",
        "move_slider_right": "move the sliding door to the right",
        "open_drawer": "open the drawer",
        "close_drawer": "close the drawer",
        "place_in_slider": "put the block into the sliding cabinet",
        "place_in_drawer": "put the block away in the drawer",
        "stack_block": "set the block down on top of another block",
        "unstack_block": "take the top block off the stack",
        "turn_on_lightbulb": "turn on the light bulb",
        "turn_off_lightbulb": "turn off the light bulb",
        "turn_on_led": "turn on the led",
        "turn_off_led": "turn off the led",
        "push_into_drawer": "push the block into the drawer",
    })
    for c in COLORS:
        bank[f"lift_{c}_block_table"] = f"pick the {c} block up from the tabletop"
        bank[f"lift_{c}_block_slider"] = f"grab the {c} block off the shelf"
        bank[f"lift_{c}_block_drawer"] = f"pick the {c} block up from inside the drawer"
    if set(bank) != set(TASK_NAMES):
        raise AssertionError("the validation bank does not cover the task set")
    return bank


VALIDATION_BANK = build_validation_bank()
