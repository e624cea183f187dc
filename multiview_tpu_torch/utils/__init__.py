"""utils: port of multiview_tpu.utils."""
