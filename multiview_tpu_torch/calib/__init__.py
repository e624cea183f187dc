"""calib: port of multiview_tpu.calib."""
