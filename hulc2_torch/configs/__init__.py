"""The port's config registry: importing the package registers every policy
group and root (``configs/policy.py``), as ``hulc2_tpu.configs`` does."""
from hulc2_torch.configs import policy  # noqa: F401  (registers the groups on import)
