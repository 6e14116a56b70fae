"""A fold's set-up in ``trainer.train_records`` before its first step
(labels, pools, the model and its weights, the validation batches): from
the call's entry to the first train step's (the name the configuration's
head gives), both synchronised; the mean over the span phase's folds, in
ms."""
FOLD = "edsnet_torch.trainer:train_records"


def spans(cell):
    return (FOLD, cell.model.HEAD.targets["train_step"])


def read(t):
    step = t.cell.model.HEAD.targets["train_step"]
    folds, steps = t.spans.get(FOLD), sorted(t.spans.get(step, []))
    if not folds or not steps:
        return None
    waits = []
    for start, end in folds:
        first = [a for a, _ in steps if start <= a <= end]
        if first:
            waits.append(min(first) - start)
    return 1e3 * sum(waits) / len(waits) if waits else None
