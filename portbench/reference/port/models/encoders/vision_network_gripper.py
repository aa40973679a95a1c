"""The gripper camera's CNN; the frame side fixes its trunk's flatten width."""
from portbench.reference.port.models.vision import VisionNetworkGripper


def build(cfg: dict, hw: int) -> VisionNetworkGripper:
    return VisionNetworkGripper(hw, **{k: v for k, v in cfg.items() if k != "_name_"})
