from .constraints import (
    active_mesh,
    constrain,
    get_active_mesh,
    set_active_mesh,
    shard_model,
    shard_over_dp,
)
from .sharding import (
    activation_pspec,
    batch_pspecs,
    cache_pspecs,
    dp_axes,
    named,
    param_pspecs,
)
from .device_groups import (
    BuddyAllocator,
    DeviceGroup,
    assign_wave_groups,
    groups_footprint,
    pow2_floor,
    scale_group,
)

__all__ = [k for k in dir() if not k.startswith("_")]
