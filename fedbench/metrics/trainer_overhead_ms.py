"""Host time of a round outside the executor's step: the program's
``scheduler.round`` span less its ``executor.execute`` child, averaged
over the rounds of the spans stretch (batch draws and host copies, the
scheduler, the cohort's placement)."""

LAYER = "trainer"
UNIT = "ms/round"
SOURCE = "program_span"
MOVES = "round_ms"


def read(r):
    if r.kind != "round" or not r.spans:
        return None
    spans = [e for e in r.spans if e.get("type") == "span"
             and e.get("lane") == "host"]
    rounds = [e for e in spans if e["name"] == "scheduler.round"]
    execs = [e for e in spans if e["name"] == "executor.execute"]
    if not rounds:
        return None
    total = 0.0
    for rd in rounds:
        inner = [e for e in execs
                 if rd["t0"] <= e["t0"] and e["t1"] <= rd["t1"]]
        if len(inner) != 1:
            return None      # a round without exactly one step: no reading
        total += (rd["t1"] - rd["t0"]) - (inner[0]["t1"] - inner[0]["t0"])
    return total / len(rounds) * 1e3
