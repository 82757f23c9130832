from .ply import load_scene_ply, read_ply_vertex_table, save_scene_ply, write_ply_vertex_table

__all__ = [
    "load_scene_ply",
    "read_ply_vertex_table",
    "save_scene_ply",
    "write_ply_vertex_table",
]
