"""Processes, the device mesh and the rows of a data-parallel rank (``hulc2_tpu/parallel``)."""
