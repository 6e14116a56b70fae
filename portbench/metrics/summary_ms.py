"""The keyshot summary and its F-score in an evaluation pass
(``ops/summary.py``: ``keyshot_summ``, whose knapsack loop is
``ops/knapsack.py``, and ``f1_score``): their synchronised spans summed,
per pass, in ms."""
PASS = "edsnet_torch.parallel.eval_device:evaluate_on_device"
SUMM = "edsnet_torch.ops.summary:keyshot_summ"
F1 = "edsnet_torch.ops.summary:f1_score"


def spans(cell):
    return (PASS, SUMM, F1)


def read(t):
    passes = t.spans.get(PASS)
    runs = t.spans.get(SUMM, []) + t.spans.get(F1, [])
    if not passes or not runs:
        return None
    return 1e3 * sum(b - a for a, b in runs) / len(passes)
