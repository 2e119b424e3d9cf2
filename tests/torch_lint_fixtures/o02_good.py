"""obslint O02 good twin: consumers read only contracted fields."""


def fold(events):
    rounds = [e for e in events if e.get("type") == "round"]
    out = []
    for r in rounds:
        out.append(r.get("per_round_s"))
        # 'legacy_tag' is an *external* field: written outside the
        # static view (legacy journals), contracted in the registry
        out.append(r.get("legacy_tag"))
    return out
