from gaze_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh, shard_batch

__all__ = ["DATA_AXIS", "Mesh", "make_mesh", "shard_batch"]
