"""A train step (the name the configuration's head gives, ``parallel.
steps.ab_train_step`` for the anchor-based head, as the trainer calls
it: labels, forward, losses, backward, Adam): every step's synchronised
span over their count, in ms."""


def spans(cell):
    return (cell.model.HEAD.targets["train_step"],)


def read(t):
    steps = t.spans.get(t.cell.model.HEAD.targets["train_step"])
    if not steps:
        return None
    return 1e3 * sum(b - a for a, b in steps) / len(steps)
