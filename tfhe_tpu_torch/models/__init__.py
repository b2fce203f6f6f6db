"""Schemes built on the PBS: shortint."""
