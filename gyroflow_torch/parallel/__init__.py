from .pipeline import (FrameMesh, make_frame_mesh, make_window_step, place_window,
                       stabilize_window, stabilize_window_production,
                       stabilize_window_sharded, stack_dynamics, stack_meshes)

__all__ = ["stabilize_window", "stabilize_window_sharded", "make_frame_mesh",
           "make_window_step", "place_window", "stabilize_window_production",
           "stack_dynamics", "stack_meshes", "FrameMesh"]
