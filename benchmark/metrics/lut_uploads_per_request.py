"""LUT host-to-device copies (`models/shortint.generate_lut.uploads`) over
the window, per /evaluate request: each is a blocking copy from pageable
memory, which on the card waits for the work queued before it. Missing
where the program does not count them."""

from tfhe_tpu_torch.models import shortint

# a program that does not count the uploads (an older checkout) leaves this
# metric out
COUNTERS = ({"lut_uploads": "tfhe_tpu_torch.models.shortint:generate_lut.uploads"}
            if hasattr(shortint.generate_lut, "uploads") else {})


def read(run):
    n, uploads = run.facts.get("attempted"), run.counters.get("lut_uploads")
    return uploads / n if n and uploads is not None else None
