"""Ciphertext and key layer: keys, LWE, GLWE, GGSW, bootstrap, packing
keyswitch, seeded and compressed GLWE."""
