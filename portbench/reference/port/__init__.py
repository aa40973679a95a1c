"""PyTorch/CUDA port of the HULC++ policy stack (``hulc2_tpu`` is the JAX reference).

Module names follow ``hulc2_tpu`` so each counterpart is easy to find. The
package imports torch and never jax or anything of ``hulc2_tpu``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; without a card they
raise rather than fall back.
"""
