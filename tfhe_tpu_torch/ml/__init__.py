"""ML layers over the port's encrypted primitives."""
