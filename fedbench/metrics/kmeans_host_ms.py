"""Host time of the k-means a round runs: the benchmark's span around
every ``repro_torch.core.kmeans.batched_lloyd`` call inside a round
(seeding with its L - 1 farthest-point steps, and the Lloyd iterations'
launches), summed and averaged over the rounds of the spans stretch. The
count of spans must be the calls the rounds make."""

LAYER = "k-means"
UNIT = "ms/round"
SOURCE = "program_span"
MOVES = "round_ms"


def read(r):
    if r.kind != "round" or not r.spans or not r.kmeans_calls_per_round:
        return None
    spans = [e for e in r.spans if e.get("type") == "span"
             and e.get("lane") == "host"]
    rounds = [e for e in spans if e["name"] == "scheduler.round"]
    lloyd = [e for e in spans if e["name"] == "fedbench.batched_lloyd"
             and any(rd["t0"] <= e["t0"] and e["t1"] <= rd["t1"]
                     for rd in rounds)]
    if not rounds or len(lloyd) != len(rounds) * r.kmeans_calls_per_round:
        return None
    return sum(e["t1"] - e["t0"] for e in lloyd) / len(rounds) * 1e3
