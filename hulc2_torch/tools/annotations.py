"""Language annotation bank: natural-language paraphrases per CALVIN task.

Role of the reference's sentence bank (conf/annotations/new_playtable.yaml,
389 sentences, consumed by hulc2/utils/automatic_lang_annotator_mp.py).
Paraphrases here are this framework's own phrasings — 12 per task, 408 total
across the 34 tasks — matching the reference bank's scale; extend freely,
samplers draw uniformly.

The port's copy of ``hulc2_tpu/tools/annotations.py``, unchanged but for its
imports: the dataset generator samples training sentences from
``ANNOTATION_BANK``; validation windows and evaluation goals use
``VALIDATION_BANK``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from hulc2_torch.evaluation.tasks import COLORS, TASK_NAMES


def _block_phrases(verb: str, color: str, direction: str = None) -> List[str]:
    obj = f"the {color} block"
    if verb == "rotate":
        return [
            f"rotate {obj} to the {direction}",
            f"turn {obj} a little {direction}",
            f"spin {obj} towards the {direction}",
            f"rotate {obj} {direction}",
            f"grab {obj} and turn it to the {direction}",
            f"twist {obj} to the {direction}",
            f"give {obj} a turn to the {direction}",
            f"pick {obj} and rotate it {direction}wards",
            f"swivel {obj} to the {direction}",
            f"turn {obj} so it faces {direction}",
            f"rotate {obj} a bit to the {direction}",
            f"take {obj} and spin it {direction}",
        ]
    if verb == "push":
        return [
            f"push {obj} to the {direction}",
            f"slide {obj} {direction}",
            f"move {obj} to the {direction}",
            f"push {obj} {direction}",
            f"shove {obj} to the {direction}",
            f"sweep {obj} towards the {direction}",
            f"nudge {obj} {direction}",
            f"slide {obj} over to the {direction} side",
            f"push {obj} over to the {direction}",
            f"scoot {obj} to the {direction}",
            f"move {obj} a little to the {direction}",
            f"drag {obj} towards the {direction}",
        ]
    raise ValueError(verb)


def build_annotation_bank() -> Dict[str, List[str]]:
    bank: Dict[str, List[str]] = {}
    for verb in ("rotate", "push"):
        for c in COLORS:
            for d in ("right", "left"):
                bank[f"{verb}_{c}_block_{d}"] = _block_phrases(verb, c, d)
    bank["move_slider_left"] = ["move the sliding door to the left", "push the slider left",
                                "slide the cabinet door over to the left side", "grab the slider and move it left",
                                "push the sliding door towards the left", "shift the cabinet door left",
                                "move the slider over to the left", "slide the cabinet door leftwards",
                                "grab the handle and slide the door left",
                                "push the shelf door to the left",
                                "drag the sliding panel to the left",
                                "shift the sliding door all the way left"]
    bank["move_slider_right"] = ["move the sliding door to the right", "push the slider right",
                                 "slide the cabinet door over to the right side", "grab the slider and move it right",
                                 "push the sliding door towards the right", "shift the cabinet door right",
                                 "move the slider over to the right", "slide the cabinet door rightwards",
                                 "grab the handle and slide the door right",
                                 "push the shelf door to the right",
                                 "drag the sliding panel to the right",
                                 "shift the sliding door all the way right"]
    bank["open_drawer"] = ["open the drawer", "pull the drawer open", "tug on the drawer handle to open it",
                           "grasp the handle and open the drawer", "slide the drawer out",
                           "pull open the drawer below the table",
                           "pull out the drawer", "tug the drawer open",
                           "open up the drawer under the table",
                           "grab the drawer handle and pull it towards you",
                           "draw the drawer out from the table",
                           "open the drawer by its handle"]
    bank["close_drawer"] = ["close the drawer", "push the drawer shut", "push the drawer closed",
                            "grasp the handle and close the drawer", "slide the drawer back in",
                            "push the drawer back under the table",
                            "push in the drawer", "shut the drawer",
                            "close up the drawer under the table",
                            "push the drawer until it is closed",
                            "slide the drawer shut",
                            "press the drawer back into the table"]
    for c in COLORS:
        bank[f"lift_{c}_block_table"] = [
            f"pick the {c} block up from the tabletop",
            f"lift the {c} block off the table",
            f"grab the {c} block on the table",
            f"lift up the {c} block",
            f"grasp the {c} block and lift it",
            f"pick the {c} block up off the table",
            f"raise the {c} block from the tabletop",
            f"grasp the {c} block lying on the table and raise it",
            f"pick up the {c} block lying on the table",
            f"take hold of the {c} block and raise it up",
            f"lift the {c} block into the air",
            f"grab hold of the {c} block and pick it up",
        ]
        bank[f"lift_{c}_block_slider"] = [
            f"grab the {c} block off the shelf",
            f"take the {c} block out of the slider",
            f"grab the {c} block from the sliding cabinet",
            f"lift the {c} block in the slider",
            f"grasp the {c} block inside the cabinet and lift it",
            f"fetch the {c} block from the shelf",
            f"pick the {c} block out of the sliding cabinet",
            f"reach into the slider and pick up the {c} block",
            f"take the {c} block sitting on the shelf",
            f"lift the {c} block out of the cabinet",
            f"grab the {c} block stored in the slider",
            f"collect the {c} block from the shelf",
        ]
        bank[f"lift_{c}_block_drawer"] = [
            f"pick the {c} block up from inside the drawer",
            f"take the {c} block out of the drawer",
            f"raise the {c} block resting in the drawer",
            f"grasp the {c} block in the drawer and lift it out",
            f"fetch the {c} block from inside the drawer",
            f"reach into the drawer and pick up the {c} block",
            f"pick the {c} block out of the open drawer",
            f"grab the {c} block sitting in the drawer",
            f"lift the {c} block up out of the drawer",
            f"take out the {c} block from the drawer",
            f"retrieve the {c} block from the drawer",
            f"collect the {c} block lying in the drawer",
        ]
    bank["place_in_slider"] = ["put the block into the sliding cabinet", "store the block in the sliding cabinet",
                               "place the grasped block on the shelf",
                               "set the block down inside the slider",
                               "put the block you are holding into the cabinet",
                               "place the block onto the shelf of the sliding door",
                               "store the grasped block on the shelf",
                               "move the block into the sliding cabinet",
                               "put away the block inside the slider",
                               "deposit the block on the cabinet shelf",
                               "set the block you are carrying into the slider",
                               "stow the block in the sliding compartment"]
    bank["place_in_drawer"] = ["put the block away in the drawer", "stash the block in the drawer",
                               "drop the grasped block into the drawer",
                               "set the block down inside the drawer",
                               "put the block you are holding into the drawer",
                               "place the block into the open drawer",
                               "put away the block inside the drawer",
                               "deposit the block in the open drawer",
                               "move the block you are carrying into the drawer",
                               "lower the block into the drawer",
                               "stow the block inside the drawer",
                               "let the block down into the drawer"]
    bank["stack_block"] = ["set the block down on top of another block", "place the block on another block",
                           "put the held block on top of one of the blocks",
                           "set the block you hold onto another block",
                           "stack the blocks", "build a tower with the blocks",
                           "place one block on top of the other",
                           "pile the block onto another block",
                           "balance the block on top of a second block",
                           "put the block down on another block",
                           "stack the grasped block onto one of the others",
                           "make a stack out of the blocks"]
    bank["unstack_block"] = ["take the top block off the stack", "remove the block from the stack",
                             "unstack the blocks", "lift the top block off the tower",
                             "collapse the stack by removing the upper block",
                             "take the block sitting on top of the other one",
                             "pick the upper block off the stack",
                             "take down the block on top",
                             "remove the topmost block from the pile",
                             "lift away the block resting on the other block",
                             "take apart the stack of blocks",
                             "grab the top block and set it aside"]
    bank["turn_on_lightbulb"] = ["turn on the light bulb", "move the switch up to turn on the bulb",
                                 "switch on the yellow light", "flip the switch to light the bulb",
                                 "toggle the switch so the bulb turns on",
                                 "make the light bulb glow",
                                 "push the switch upwards to light the bulb",
                                 "turn the light bulb on with the switch",
                                 "flick the switch up so the bulb lights",
                                 "activate the light bulb",
                                 "use the switch to turn the bulb on",
                                 "light up the bulb"]
    bank["turn_off_lightbulb"] = ["turn off the light bulb", "move the switch down to turn off the bulb",
                                  "switch off the yellow light", "flip the switch to kill the bulb",
                                  "toggle the switch so the bulb turns off",
                                  "make the light bulb go dark",
                                  "push the switch downwards to darken the bulb",
                                  "turn the light bulb off with the switch",
                                  "flick the switch down so the bulb goes out",
                                  "deactivate the light bulb",
                                  "use the switch to turn the bulb off",
                                  "put out the light bulb"]
    bank["turn_on_led"] = ["turn on the led", "press the button to switch on the led",
                           "press the button so the green light comes on",
                           "tap the button so the led lights up",
                           "hit the button to light the led", "switch the led on",
                           "press down the button and turn the led on",
                           "turn the green light on with the button",
                           "push down on the button so the led comes on",
                           "activate the led by pressing the button",
                           "make the led light up",
                           "press the button until the led is on"]
    bank["turn_off_led"] = ["turn off the led", "press the button to switch off the led",
                            "press the button so the green light goes off",
                            "tap the button so the led goes dark",
                            "hit the button to kill the led", "switch the led off",
                            "press down the button and turn the led off",
                            "turn the green light off with the button",
                            "push down on the button so the led goes out",
                            "deactivate the led by pressing the button",
                            "make the led go dark",
                            "press the button until the led is off"]
    bank["push_into_drawer"] = ["push the block into the drawer", "sweep the block into the open drawer",
                                "slide the block off the table into the drawer",
                                "push the block over the edge into the drawer",
                                "shove the block from the table into the drawer below",
                                "sweep the block so it drops into the drawer",
                                "push the block off the table so it lands in the drawer",
                                "slide the block along the table into the open drawer",
                                "nudge the block into the drawer",
                                "push the block until it falls into the drawer",
                                "sweep the block off the tabletop into the drawer",
                                "drive the block into the open drawer"]
    assert set(bank) == set(TASK_NAMES)
    return bank


ANNOTATION_BANK = build_annotation_bank()


def build_validation_bank() -> Dict[str, str]:
    """One canonical instruction per task for the validation split.

    Role of the reference's validation sentence bank
    (conf/annotations/new_playtable_validation.yaml, bound via
    ``annotations@val_instructions`` in conf/lang_ann.yaml:10): validation
    windows and the evaluation ``embeddings.npy`` lookup use a single fixed
    phrasing per task so val metrics are not confounded by paraphrase
    sampling. Phrasings are this framework's own.
    """
    bank = {t: opts[0] for t, opts in ANNOTATION_BANK.items()}
    assert set(bank) == set(TASK_NAMES)
    return bank


VALIDATION_BANK = build_validation_bank()

# paraphrase-generalization protocol: hold out the LAST K paraphrases of each
# task for evaluation only — training samples from the first 12-K (which
# include the canonical phrasing at index 0). With a real (compositional)
# language encoder, success on held-out phrasings measures semantic
# generalization; the reference gets this property from frozen SBERT
# (hulc2/models/encoders/language_network.py:13), here it must be LEARNED by
# the in-graph tower.
HOLDOUT_K = 4


def heldout_annotations(task: str, holdout_k: int = HOLDOUT_K) -> List[str]:
    """The evaluation-only paraphrases for ``task`` (never sampled when
    training data is annotated with the same ``holdout_k``)."""
    return ANNOTATION_BANK[task][-holdout_k:]


def sample_annotation(task: str, rng: np.random.Generator, validation: bool = False,
                      holdout_k: int = 0) -> str:
    if validation:
        return VALIDATION_BANK[task]
    options = ANNOTATION_BANK[task]
    if holdout_k:
        options = options[: len(options) - holdout_k]
    return options[int(rng.integers(len(options)))]
