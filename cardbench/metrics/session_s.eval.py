"""session_s.eval: an answer's host seconds outside the model: its wall
time less the time inside the eval steps (each synchronised), in the
traced run's answers."""


def read(rec):
    s = rec.get("session_s")
    return sum(s) / len(s) if s else None
