"""Device: the share of the traced window in which nothing ran on the card
(no kernel, copy or set in ``torch.profiler``'s device activities). Moves
``summarize_s``."""


def read(r):
    t = r.trace
    if t is None or t.busy_s <= 0.0 or r.window_s <= 0.0:
        return None
    return max(0.0, 1.0 - t.busy_s / r.window_s) * 100.0
