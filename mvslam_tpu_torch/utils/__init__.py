"""Synthetic test scenes and device timing helpers."""
