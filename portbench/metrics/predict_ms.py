"""The model's ``predict`` (the name the configuration's head gives,
``models/dsnet.py``'s for the anchor-based head: the forward and the
anchor decode) in an evaluation pass: its synchronised spans summed over
the span phase, per pass, in ms."""
PASS = "edsnet_torch.parallel.eval_device:evaluate_on_device"


def spans(cell):
    return (PASS, cell.model.HEAD.targets["predict"])


def read(t):
    predict = t.cell.model.HEAD.targets["predict"]
    passes, runs = t.spans.get(PASS), t.spans.get(predict)
    if not passes or not runs:
        return None
    return 1e3 * sum(b - a for a, b in runs) / len(passes)
