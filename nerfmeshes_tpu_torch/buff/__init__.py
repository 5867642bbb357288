"""BuFF: training, rendering and meshing through the adaptive voxel tree
(counterpart of nerfmeshes_tpu/buff/)."""

from nerfmeshes_tpu_torch.buff.system import (
    BuFFSystem,
    buff_render_rays,
    buff_train_loss,
    make_buff_train_step,
)
from nerfmeshes_tpu_torch.buff.tree import (
    AUTO_CHORD_CAP,
    Leaf,
    TreeSampling,
    TreeState,
    integrate,
    ray_voxel_intersect,
)

__all__ = [
    "AUTO_CHORD_CAP",
    "BuFFSystem",
    "Leaf",
    "TreeSampling",
    "TreeState",
    "buff_render_rays",
    "buff_train_loss",
    "integrate",
    "make_buff_train_step",
    "ray_voxel_intersect",
]
