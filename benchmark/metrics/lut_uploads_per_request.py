"""LUT host-to-device copies (`models/shortint.generate_lut.uploads`) over
the window, per /evaluate request: each is a blocking copy from pageable
memory, which on the card waits for the work queued before it."""

COUNTERS = {"lut_uploads": "tfhe_tpu_torch.models.shortint:generate_lut.uploads"}


def read(run):
    n, uploads = run.facts.get("attempted"), run.counters.get("lut_uploads")
    return uploads / n if n and uploads is not None else None
