"""Symbolic CALVIN task model: 34 tasks as precondition/effect rules.

Semantically identical to the reference's task tables
(reference: hulc2/evaluation/multistep_sequences.py:17-260) — the benchmark
protocol requires the exact same task set, rule variants and *registry
ordering* (sequence generation draws task names with seeded
``np.random.choice`` over this ordering, so any reordering changes the
benchmark). Here the rules are generated programmatically per block color /
direction instead of spelled out, which both shrinks the table and makes the
structure explicit.

World state variables: led/lightbulb in {0,1}, slider in {left,right}, drawer
in {open,closed}, {red,blue,pink}_block in {table, slider_left, slider_right,
drawer, grasped, stacked_top, stacked_bottom}, grasped in {0,1}.

The port's copy of ``hulc2_tpu/evaluation/tasks.py``, unchanged but for its imports.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple, Union

Value = Union[str, int, List[str]]
StateDict = Dict[str, Value]

COLORS = ("red", "blue", "pink")


@dataclass(frozen=True)
class Rule:
    """One admissible variant of a task: applicable iff ``when`` holds
    (list values mean set membership), transforms the state by ``then``."""

    when: StateDict
    then: StateDict

    def applies(self, state: StateDict) -> bool:
        for k, v in self.when.items():
            if isinstance(v, list):
                if state[k] not in v:
                    return False
            elif state[k] != v:
                return False
        return True

    def apply(self, state: StateDict) -> StateDict:
        out = dict(state)
        out.update(self.then)
        return out


def _build_registry() -> Dict[str, List[Rule]]:
    reg: Dict[str, List[Rule]] = {}

    def block(c):
        return f"{c}_block"

    # rotate / push: block on table, hand free, stays on table
    for verb in ("rotate", "push"):
        for c in COLORS:
            for direction in ("right", "left"):
                reg[f"{verb}_{c}_block_{direction}"] = [
                    Rule({block(c): "table", "grasped": 0}, {block(c): "table"})
                ]

    reg["move_slider_left"] = [Rule({"slider": "right", "grasped": 0}, {"slider": "left"})]
    reg["move_slider_right"] = [Rule({"slider": "left", "grasped": 0}, {"slider": "right"})]
    reg["open_drawer"] = [Rule({"drawer": "closed", "grasped": 0}, {"drawer": "open"})]
    reg["close_drawer"] = [Rule({"drawer": "open", "grasped": 0}, {"drawer": "closed"})]

    # lift from table / slider / drawer
    for c in COLORS:
        grab = {block(c): "grasped", "grasped": 1}
        reg[f"lift_{c}_block_table"] = [Rule({block(c): "table", "grasped": 0}, grab)]
        reg[f"lift_{c}_block_slider"] = [
            Rule({block(c): "slider_left", "slider": "right", "grasped": 0}, grab),
            Rule({block(c): "slider_right", "slider": "left", "grasped": 0}, grab),
        ]
        reg[f"lift_{c}_block_drawer"] = [
            Rule({block(c): "drawer", "drawer": "open", "grasped": 0}, grab)
        ]

    reg["place_in_slider"] = [
        Rule(
            {block(c): "grasped", "slider": side, "grasped": 1},
            {block(c): f"slider_{side}", "grasped": 0},
        )
        for c in COLORS
        for side in ("right", "left")
    ]
    reg["place_in_drawer"] = [
        Rule(
            {block(c): "grasped", "drawer": "open", "grasped": 1},
            {block(c): "drawer", "grasped": 0},
        )
        for c in COLORS
    ]
    reg["stack_block"] = [
        Rule(
            {block(top): "grasped", block(bot): "table", "grasped": 1},
            {block(top): "stacked_top", block(bot): "stacked_bottom", "grasped": 0},
        )
        for top in COLORS
        for bot in COLORS
        if bot != top
    ]
    reg["unstack_block"] = [
        Rule(
            {block(top): "stacked_top", block(bot): "stacked_bottom", "grasped": 0},
            {block(top): "table", block(bot): "table"},
        )
        for top in COLORS
        for bot in COLORS
        if bot != top
    ]

    for dev in ("lightbulb", "led"):
        reg[f"turn_on_{dev}"] = [Rule({dev: 0, "grasped": 0}, {dev: 1})]
        reg[f"turn_off_{dev}"] = [Rule({dev: 1, "grasped": 0}, {dev: 0})]

    in_slider = ["slider_right", "slider_left"]
    reg["push_into_drawer"] = [
        Rule(
            {
                block(c): "table",
                **{block(o): in_slider for o in COLORS if o != c},
                "drawer": "open",
                "grasped": 0,
            },
            {block(c): "drawer", "grasped": 0},
        )
        for c in COLORS
    ]
    return reg


TASK_REGISTRY: Dict[str, List[Rule]] = _build_registry()
TASK_NAMES: Tuple[str, ...] = tuple(TASK_REGISTRY)

# mutual-exclusion categories: a valid 5-chain uses 5 distinct categories
# (reference: multistep_sequences.py:17-52)
TASK_CATEGORIES: Dict[str, int] = {}
for _name in TASK_NAMES:
    if _name.startswith(("rotate_", "push_") ) and "_block_" in _name:
        TASK_CATEGORIES[_name] = 1
    elif _name.startswith("move_slider"):
        TASK_CATEGORIES[_name] = 2
    elif _name.endswith("_drawer") and _name.split("_")[0] in ("open", "close"):
        TASK_CATEGORIES[_name] = 3
    elif _name.startswith("lift_") and _name.endswith("_table"):
        TASK_CATEGORIES[_name] = 4
    elif _name.startswith("lift_") and _name.endswith("_slider"):
        TASK_CATEGORIES[_name] = 5
    elif _name.startswith("lift_") and _name.endswith("_drawer"):
        TASK_CATEGORIES[_name] = 6
    elif _name.startswith("place_in"):
        TASK_CATEGORIES[_name] = 7
    elif _name.startswith(("turn_on", "turn_off")):
        TASK_CATEGORIES[_name] = 8
    elif _name == "push_into_drawer":
        TASK_CATEGORIES[_name] = 9
    elif _name == "stack_block":
        TASK_CATEGORIES[_name] = 10
    elif _name == "unstack_block":
        TASK_CATEGORIES[_name] = 11


def successor_states(state: StateDict, task_name: str) -> List[StateDict]:
    """All next states reachable by performing ``task_name`` in ``state``."""
    return [r.apply(state) for r in TASK_REGISTRY[task_name] if r.applies(state)]


def is_chain_valid(state: StateDict, chain) -> bool:
    """A chain is valid iff every task is *unambiguously* applicable in turn
    (exactly one rule variant fires) and all 5 categories are distinct
    (reference: multistep_sequences.py:324-331)."""
    for name in chain:
        nxt = successor_states(state, name)
        if len(nxt) != 1:
            return False
        state = nxt[0]
    cats = [TASK_CATEGORIES[n] for n in chain]
    return len(cats) == len(set(cats))
