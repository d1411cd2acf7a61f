"""Run set-up and final sparsification: a run's wall less its rounds' walls,
averaged over the window's complete runs: ``make_graph`` (the host's
canonical check and the copy to the card), the final pair table and
``further_sparsify``, and the copy of the summary to the host. Moves
``summarize_s``."""


def read(r):
    if not r.runs:
        return None
    return sum(run["wall_s"] - sum(run["round_s"]) for run in r.runs) / len(r.runs) * 1e3
