"""Lie groups and small-matrix linear algebra."""
