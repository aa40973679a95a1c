"""The 34 CALVIN task names in the registry's order, whose index is a lang
row's task id: the order of ``hulc2_tpu/evaluation/tasks.py``'s
``TASK_REGISTRY`` (the upstream ``multistep_sequences.py`` tables), written
out."""
from typing import Tuple

TASK_NAMES: Tuple[str, ...] = (
    'rotate_red_block_right',
    'rotate_red_block_left',
    'rotate_blue_block_right',
    'rotate_blue_block_left',
    'rotate_pink_block_right',
    'rotate_pink_block_left',
    'push_red_block_right',
    'push_red_block_left',
    'push_blue_block_right',
    'push_blue_block_left',
    'push_pink_block_right',
    'push_pink_block_left',
    'move_slider_left',
    'move_slider_right',
    'open_drawer',
    'close_drawer',
    'lift_red_block_table',
    'lift_red_block_slider',
    'lift_red_block_drawer',
    'lift_blue_block_table',
    'lift_blue_block_slider',
    'lift_blue_block_drawer',
    'lift_pink_block_table',
    'lift_pink_block_slider',
    'lift_pink_block_drawer',
    'place_in_slider',
    'place_in_drawer',
    'stack_block',
    'unstack_block',
    'turn_on_lightbulb',
    'turn_off_lightbulb',
    'turn_on_led',
    'turn_off_led',
    'push_into_drawer',
)
