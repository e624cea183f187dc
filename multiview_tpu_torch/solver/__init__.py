"""solver: port of multiview_tpu.solver."""
