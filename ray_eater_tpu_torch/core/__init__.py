"""Pipelines, resources and shaders of the port (counterpart of
``ray_eater_tpu/core``)."""
