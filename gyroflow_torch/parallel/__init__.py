from .pipeline import (FrameMesh, make_frame_mesh, make_window_step, place_window,
                       stabilize_window_production, stack_dynamics, stack_meshes)

__all__ = ["FrameMesh", "make_frame_mesh", "make_window_step", "place_window",
           "stabilize_window_production", "stack_dynamics", "stack_meshes"]
