"""forwards_per_answer.eval: the model forwards (documents) an answer
took, as ``EarlEval`` counts them (``model_forwards``), over the window's
answers."""


def read(rec):
    f = rec.get("forwards")
    return sum(f) / len(f) if f else None
