"""sfm: port of multiview_tpu.sfm."""
