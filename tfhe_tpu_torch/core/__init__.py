"""Ciphertext and key layer: keys, LWE, GLWE, GGSW, bootstrap."""
