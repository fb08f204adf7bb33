"""setup_s: seconds from the start of the process to the first request of
the window (Python, torch, the card, the kernel library, the warm-up)."""


def read(rec):
    return rec.setup_s
