"""The greedy NMS (``ops/bbox.py:nms_masked``, as the evaluator calls
it) in an evaluation pass: its synchronised spans summed, per pass, in
ms."""
PASS = "edsnet_torch.parallel.eval_device:evaluate_on_device"
NMS = "edsnet_torch.parallel.eval_device:nms_masked"


def spans(cell):
    return (PASS, NMS)


def read(t):
    passes, runs = t.spans.get(PASS), t.spans.get(NMS)
    if not passes or not runs:
        return None
    return 1e3 * sum(b - a for a, b in runs) / len(passes)
