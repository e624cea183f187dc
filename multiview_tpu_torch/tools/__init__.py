"""tools: port of multiview_tpu.tools."""
