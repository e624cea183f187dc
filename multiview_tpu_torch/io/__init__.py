"""io: port of multiview_tpu.io."""
