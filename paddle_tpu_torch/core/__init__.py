"""Core helpers: error types, device resolution, meshes and flags."""
