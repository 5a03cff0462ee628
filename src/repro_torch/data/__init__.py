"""Synthetic graph data (R-MAT, Zipf), made on the host with numpy."""
