"""Core helpers: error types and device resolution."""
