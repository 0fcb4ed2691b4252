"""Host image I/O of the port (counterpart of ``ray_eater_tpu/io``)."""
