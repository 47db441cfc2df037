from mulactseg_tpu_torch.parallel.mesh import (
    active,
    all_gather_rows,
    all_reduce_grads,
    all_reduce_sum,
    barrier,
    broadcast_object,
    broadcast_state,
    init_distributed,
    init_from_env,
    is_main,
    local_rows,
    pad_to_multiple,
    rank,
    spawn,
    world,
)

__all__ = ["active", "all_gather_rows", "all_reduce_grads", "all_reduce_sum",
           "barrier", "broadcast_object", "broadcast_state",
           "init_distributed", "init_from_env", "is_main", "local_rows",
           "pad_to_multiple", "rank", "spawn", "world"]
