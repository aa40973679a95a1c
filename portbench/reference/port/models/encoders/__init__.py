"""The reference's camera encoders, one module each, found by the
``_name_`` of a camera's encoder config (``build.build_camera_encoder``):
``<_name_>.py`` exposes ``build(cfg, hw) -> nn.Module``, where ``cfg`` is the
camera's encoder config and ``hw`` its frame side after the train
transform (``device_transforms.camera_sizes``). The module takes NCHW
frames as ``(x, deterministic, generator)``."""
