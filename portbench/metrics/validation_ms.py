"""An epoch's validation on the device evaluator
(``parallel.eval_device.eval_fscore_device``, as the trainer calls it):
the mean of its synchronised spans, in ms."""
VALIDATE = "edsnet_torch.trainer:eval_fscore_device"


def spans(cell):
    return (VALIDATE,)


def read(t):
    runs = t.spans.get(VALIDATE)
    if not runs:
        return None
    return 1e3 * sum(b - a for a, b in runs) / len(runs)
