"""Schemes built on the PBS: shortint, radix integers."""
