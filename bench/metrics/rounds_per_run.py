"""Engine: merge rounds a run takes, ``ensure_budget`` rounds included,
averaged over the window's complete runs. Moves ``summarize_s``."""


def read(r):
    return sum(len(run["round_s"]) for run in r.runs) / len(r.runs) if r.runs else None
