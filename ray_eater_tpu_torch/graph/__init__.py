"""The render graph (counterpart of ``ray_eater_tpu/graph/``)."""
