"""Decode tokens per tenant decode step inside the window (the batch a
decode call served; its rows beyond these were empty)."""


def read(run):
    steps = {s.idx for s in run.steps()}
    calls = [len(rows) for (_, st), rows in run.decode_rows().items()
             if st in steps]
    return sum(calls) / len(calls) if calls else None
