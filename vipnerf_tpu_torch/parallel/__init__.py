from vipnerf_tpu_torch.parallel.mesh import (  # noqa: F401
    RayGroup,
    ShardGenerator,
    StepShard,
    current_group,
    ray_shard,
    run_on_devices,
    scene_shard,
    select_devices,
)
