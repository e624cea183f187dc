"""Sharding over several devices and processes: the shard mesh, observation
and TSDF sharding, multi-process start-up and the multi-device dry run."""
