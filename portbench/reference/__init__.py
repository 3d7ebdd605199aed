"""Plain float32 references and the lower-precision control."""
