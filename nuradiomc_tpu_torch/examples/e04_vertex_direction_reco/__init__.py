"""examples/04_vertex_direction_reco: vertex, direction and energy of a
synthetic in-ice event."""
