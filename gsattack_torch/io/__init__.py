from .dataset import (
    SceneInfo,
    load_scene_info,
    read_blender_scene,
    read_colmap_scene,
    scene_load_callbacks,
    search_max_iteration,
    sniff_scene_type,
)
from .ply import (
    load_scene_ply,
    read_ply_vertex_table,
    read_points_ply,
    save_scene_ply,
    store_points_ply,
    write_ply_vertex_table,
)

__all__ = [
    "SceneInfo",
    "load_scene_info",
    "read_blender_scene",
    "read_colmap_scene",
    "scene_load_callbacks",
    "search_max_iteration",
    "sniff_scene_type",
    "load_scene_ply",
    "save_scene_ply",
    "read_ply_vertex_table",
    "write_ply_vertex_table",
    "read_points_ply",
    "store_points_ply",
]
