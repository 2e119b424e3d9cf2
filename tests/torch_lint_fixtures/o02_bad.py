"""obslint O02 bad twin: consumers reading contracts nothing produces.

Never imported -- parsed by the analyzer only.
"""


def fold(events):
    ghosts = [e for e in events if e.get("type") == "ghost_event"]  # EXPECT: O02
    rounds = [e for e in events if e.get("type") == "round"]
    out = []
    for r in rounds:
        out.append(r.get("per_round_s"))
        out.append(r.get("never_written"))  # EXPECT: O02
    return ghosts, out
