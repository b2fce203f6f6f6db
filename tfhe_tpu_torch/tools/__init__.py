"""Measurement scripts of the port, run on the card (python3 -m tfhe_tpu_torch.tools.<name>)."""
