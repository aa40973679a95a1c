"""Task decomposition: a free-form command -> a CALVIN subtask sequence.

The port's copy of ``hulc2_tpu/evaluation/llm_planning.py`` (numpy-free,
no network client). Counterpart of the reference's GPT-3 planner
(reference: hulc2/rollout/gpt3_planning.py:8-75): a few-shot prompt maps a
natural instruction to pseudo-API calls (pick_and_place / open_drawer / ...)
that resolve to CALVIN task instructions. The completion backend is
injected as ``complete_fn(prompt) -> text``; without one, a deterministic
keyword planner answers offline.
"""
from __future__ import annotations

import logging
import re
from typing import Callable, List, Optional

from hulc2_torch.evaluation.tasks import COLORS, TASK_NAMES
from hulc2_torch.tools.annotations import ANNOTATION_BANK

logger = logging.getLogger(__name__)

FEW_SHOT_PROMPT = """You control a tabletop robot. Decompose the user's command
into a sequence of calls from this API, one per line:
  open_drawer() close_drawer() move_slider_left() move_slider_right()
  turn_on_led() turn_off_led() turn_on_lightbulb() turn_off_lightbulb()
  lift(color, from) place_in(where) push(color, direction) rotate(color, direction)
  push_into_drawer() stack_block() unstack_block()

Command: tidy the red block into the drawer
Plan:
open_drawer()
lift(red, table)
place_in(drawer)
close_drawer()

Command: make the room bright
Plan:
turn_on_lightbulb()
turn_on_led()

Command: {command}
Plan:
"""

# the API calls without arguments, each a task of its own name
_API_TASKS = ("open_drawer", "close_drawer", "move_slider_left", "move_slider_right",
              "turn_on_led", "turn_off_led", "turn_on_lightbulb", "turn_off_lightbulb",
              "push_into_drawer", "stack_block", "unstack_block")


def parse_plan(text: str) -> List[str]:
    """Completion lines -> CALVIN task names; lines that name no task are dropped."""
    tasks: List[str] = []
    for line in text.strip().splitlines():
        m = re.match(r"\s*(\w+)\((.*?)\)", line)
        if not m:
            continue
        fn = m.group(1)
        args = [a.strip().strip("'\"") for a in m.group(2).split(",") if a.strip()]
        if fn in _API_TASKS:
            tasks.append(fn)
        elif fn == "lift" and len(args) == 2 and args[0] in COLORS:
            tasks.append(f"lift_{args[0]}_block_{args[1]}")
        elif fn == "place_in" and args:
            tasks.append(f"place_in_{args[0]}")
        elif fn in ("push", "rotate") and len(args) == 2 and args[0] in COLORS:
            tasks.append(f"{fn}_{args[0]}_block_{args[1]}")
    return [t for t in tasks if t in TASK_NAMES]


def keyword_planner(command: str) -> str:
    """The offline planner: one API call per task whose name or any of whose
    annotation phrases occurs in the command, in ``TASK_NAMES`` order."""
    cmd = command.lower()
    lines = []
    for task in TASK_NAMES:
        hit = task.replace("_", " ") in cmd or any(a.lower() in cmd for a in ANNOTATION_BANK[task])
        if not hit:
            continue
        parts = task.split("_")
        if task.startswith("lift_"):
            lines.append(f"lift({parts[1]}, {parts[-1]})")
        elif task.startswith(("push_", "rotate_")) and parts[1] in COLORS:
            lines.append(f"{parts[0]}({parts[1]}, {parts[-1]})")
        elif task.startswith("place_in"):
            lines.append(f"place_in({parts[-1]})")
        else:
            lines.append(f"{task}()")
    return "\n".join(lines)


class LLMPlanner:
    def __init__(self, complete_fn: Optional[Callable[[str], str]] = None):
        """``complete_fn(prompt) -> text`` answers the few-shot prompt; None
        uses ``keyword_planner``."""
        self.complete_fn = complete_fn

    def plan(self, command: str) -> List[str]:
        if self.complete_fn is None:
            text = keyword_planner(command)
        else:
            text = self.complete_fn(FEW_SHOT_PROMPT.format(command=command))
        tasks = parse_plan(text)
        logger.info("plan for %r: %s", command, tasks)
        return tasks

    def instructions(self, command: str) -> List[str]:
        """The plan as the tasks' first annotation sentences, for the policy."""
        return [ANNOTATION_BANK[t][0] for t in self.plan(command)]
