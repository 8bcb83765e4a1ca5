"""Numerical vision ops of the tracker's path."""
