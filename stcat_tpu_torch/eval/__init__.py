"""Two-stream merge and box interpolation."""
