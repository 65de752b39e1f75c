"""How unevenly the router loads the experts held here: the most pairs a
held expert took over the held experts' mean, summed over the MoE layers
and the timed window's steps (the program's histogram, read once after
the window)."""


def read(run):
    load = run.facts.get("held_load")
    if not load or sum(load) <= 0:
        return None
    return max(load) / (sum(load) / len(load))
