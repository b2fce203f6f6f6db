"""Schemes built on the PBS and the GLWE engine: shortint, radix integers,
boolean gates, the encrypted x clear matmul."""
