from nerfmeshes_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DataGroup,
    default_world,
    from_env,
    launch,
    single,
)

__all__ = ["DATA_AXIS", "DataGroup", "default_world", "from_env", "launch", "single"]
