"""The static camera's CNN with spatial-softmax keypoints; the frame side
does not enter it."""
from portbench.reference.port.models.vision import VisionNetwork


def build(cfg: dict, hw: int) -> VisionNetwork:
    return VisionNetwork(**{k: v for k, v in cfg.items() if k != "_name_"})
