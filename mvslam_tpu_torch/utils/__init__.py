"""Synthetic test scenes."""
