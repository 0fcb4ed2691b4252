"""Scene models of the port (counterpart of ``ray_eater_tpu/models``)."""
