"""Render operators of the port (counterpart of ``ray_eater_tpu/ops``)."""
