"""Mesh extraction with appearance, and surface point clouds by ray
casting (counterpart of nerfmeshes_tpu/mesh/)."""

from nerfmeshes_tpu_torch.mesh.export import export_obj, export_ply, import_obj
from nerfmeshes_tpu_torch.mesh.extract import (
    MeshArgs,
    SparseDensityGrid,
    export_marching_cubes,
    extract_geometry,
    extract_geometry_with_super_sampling,
    extract_iso_level,
    extract_radiance,
)
from nerfmeshes_tpu_torch.mesh.metrics import (
    chamfer_between_meshes,
    chamfer_distance,
    normalize_mesh,
    sample_points_from_mesh,
)
from nerfmeshes_tpu_torch.mesh.native import marching_cubes
from nerfmeshes_tpu_torch.mesh.surface_ray import (
    export_surface_ray,
    neighborhood_consistency_mask,
    surface_points_from_views,
)

__all__ = [
    "MeshArgs",
    "export_marching_cubes",
    "SparseDensityGrid",
    "extract_geometry",
    "extract_geometry_with_super_sampling",
    "extract_iso_level",
    "extract_radiance",
    "export_obj",
    "export_ply",
    "import_obj",
    "chamfer_between_meshes",
    "chamfer_distance",
    "normalize_mesh",
    "sample_points_from_mesh",
    "marching_cubes",
    "export_surface_ray",
    "neighborhood_consistency_mask",
    "surface_points_from_views",
]
