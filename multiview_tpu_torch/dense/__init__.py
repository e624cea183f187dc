"""Dense geometry: plane-sweep stereo, point-cloud filtering, TSDF fusion
and mesh extraction (the ASP parallel_stereo + voxblox roles)."""
