"""train_tokens_per_s: the training tokens of every completed step, over
the window's time to the end of the last of them."""


def read(rec):
    ends = rec.get("step_ends")
    if not ends:
        return None
    return rec["tokens_per_step"] * len(ends) / ends[-1]
