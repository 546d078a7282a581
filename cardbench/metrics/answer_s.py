"""answer_s: the window's whole time, to the end of the last answer begun
in it, over the answers it completed."""


def read(rec):
    spans = rec.get("answer_spans")
    if not spans:
        return None
    return rec["window_s"] / len(spans)
