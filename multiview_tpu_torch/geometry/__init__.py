"""geometry: port of multiview_tpu.geometry."""
