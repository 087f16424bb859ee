"""The shared reduction of the readers of the program's spans inside a
round (``r.spans``: the one ``run(300)`` call recorded with
``repro_torch.obs`` on). Not a metric: ``harness.list_metric_files``
skips a file whose name starts with ``_``."""


def per_round(r, name, count=1, less=None):
    """Host milliseconds a round of the ``name`` spans, ``count`` of them
    inside each ``scheduler.round``, averaged over the rounds; ``less =
    (inner, n)`` takes the ``n`` ``inner`` spans inside each of them away
    (self time). None on a run that is not a round's, with no spans, or
    where a round holds another count of either: the parent's program, a
    warm start, another count of k-means calls."""
    if r.kind != "round" or not r.spans or not count:
        return None
    spans = [e for e in r.spans if e.get("type") == "span"
             and e.get("lane") == "host"]

    def inside(outer, n):
        return [e for e in spans if e["name"] == n
                and outer["t0"] <= e["t0"] and e["t1"] <= outer["t1"]]

    rounds = [e for e in spans if e["name"] == "scheduler.round"]
    if not rounds:
        return None
    total = 0.0
    for rd in rounds:
        got = inside(rd, name)
        if len(got) != count:
            return None
        for e in got:
            total += e["t1"] - e["t0"]
            if less is not None:
                sub = inside(e, less[0])
                if len(sub) != less[1]:
                    return None
                total -= sum(s["t1"] - s["t0"] for s in sub)
    return total / len(rounds) * 1e3
