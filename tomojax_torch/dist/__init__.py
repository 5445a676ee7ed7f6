from tomojax_torch.dist.sharding import (
    Mesh, init_from_env, make_mesh, make_sharded_operator,
    make_volume_sharded_operator, make_volume_sharded_slab_operator,
    shard_views, sharded_refine_views,
)

__all__ = ["Mesh", "init_from_env", "make_mesh", "make_sharded_operator",
           "make_volume_sharded_operator",
           "make_volume_sharded_slab_operator", "shard_views",
           "sharded_refine_views"]
