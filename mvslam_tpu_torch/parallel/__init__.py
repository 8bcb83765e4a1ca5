"""Problem generators (the distributed solvers are not ported yet)."""
