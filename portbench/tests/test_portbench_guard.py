"""The check for the JAX stack in the run's process."""
from portbench.harness import guard


def test_port_is_not_the_jax_package():
    assert guard.forbidden_modules(["hulc2_torch", "hulc2_torch.models", "torch", "jaxtyping",
                                    "flaxen", "portbench"]) == []


def test_jax_stack_is_found():
    found = guard.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                     "optax", "hulc2_tpu", "hulc2_tpu.models", "torch"])
    assert found == ["flax.linen", "hulc2_tpu", "hulc2_tpu.models", "jax", "jax.numpy",
                     "jaxlib.xla_client", "optax"]
