from mcpt_tpu_torch.parallel.mesh import make_mesh, replicate_pack, shard_lanes

__all__ = ["make_mesh", "replicate_pack", "shard_lanes"]
