"""setup_s: seconds from the run's start (before torch is imported) to
the end of its set-up: imports, the card's context, the kernels loaded
(built on a checkout's first run), the weights and inputs made, every
shape warmed."""


def read(rec):
    return rec.get("setup_s")
