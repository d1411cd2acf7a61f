"""Engine: the mean host wall of a merge round, over every round of every
complete run in the window (``history[*]["round_s"]``, each ended by the
round's read-back of its stats). Moves ``summarize_s``."""


def read(r):
    walls = [s for run in r.runs for s in run["round_s"]]
    return sum(walls) / len(walls) * 1e3 if walls else None
