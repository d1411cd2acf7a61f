"""What the harness sees of the program's timed path: wrappers on its seams.

The port calls its stages through module attributes: the engine calls
``merge.merge_iteration``, a round calls ``tables.build_group_tables`` and
``ops.merge_gain``, the total costs call ``ops.pair_cost``. :class:`Seams`
puts a wrapper on each for the length of a run and takes them off after.
The wrappers count each kernel's launches in the run and otherwise do no
work of their own, but in two cases:

* in the round a run is asked to capture (the window's first run, the round
  drawn from the seed), they copy to the host, without waiting on the
  device: the partition and sizes before and after the round, a sample of
  the pair table's rows with the pair cost's output, and a sample of the
  groups with their members, the merge gain's operands and its output. The
  copies run inside a ``bench.capture`` span, so that a trace can tell the
  device work they add from the program's;
* in a run asked to count work (the warm-up of a traced run, before the
  profiler starts), they record each kernel launch's bytes and the entropy
  terms its operands need (:mod:`bench.roofline`). Runs of one seed repeat
  bit for bit, so the window's launches reuse these counts in order and the
  profiled window holds none of the counting.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from bench import roofline
from bench.reference.check import GROUPS, PAIR_ROWS, Capture

CAPTURE_SPAN = "bench.capture"


def _host(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` on the host that the device fills in its own time."""
    return x.detach().to("cpu", non_blocking=True)


@dataclasses.dataclass
class Launch:
    kernel: str
    nbytes: int
    terms: torch.Tensor  # 0-d, on the device
    extra_sfu: torch.Tensor | float  # divisions beyond the terms' own


class Seams:
    """Wrappers on the port's seams; one object for the whole process."""

    def __init__(self, *, seed: int, device, span=None):
        from repro_torch.core import merge, tables
        from repro_torch.kernels import ops

        self._merge, self._tables, self._ops = merge, tables, ops
        self.span = span or (lambda name: contextlib.nullcontext())
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.work: list[Launch] = []
        self.launches: dict[str, int] = {}
        self.counting = False
        self.round = 0
        self.capture_round = 0
        self.cap: dict | None = None
        self.sel: torch.Tensor | None = None

    def begin_run(self, capture_round: int = 0, *, count_work: bool = False) -> None:
        """Start a run: capture its round ``capture_round`` (0: none), and
        record each launch's work if ``count_work``."""
        self.round = 0
        self.capture_round = capture_round
        self.cap = None
        self.counting = count_work
        self.launches = {}

    def take(self) -> Capture | None:
        """The run's captured round as host arrays (the device has finished
        with it once the run has returned: its last read-back waited)."""
        if self.cap is None or "rel" not in self.cap:
            return None
        cap = {k: ((v.item() if v.dim() == 0 else v.numpy())
                   if isinstance(v, torch.Tensor) else v)
               for k, v in self.cap.items()}
        self.cap = None
        return Capture(**cap)

    def work_bounds(self) -> dict[str, list[float]]:
        """Each counted launch's bound in seconds, by kernel, in launch order
        (reads the counts back from the device)."""
        out: dict[str, list[float]] = {}
        for la in self.work:
            out.setdefault(la.kernel, []).append(
                roofline.bound_s(la.nbytes, float(la.terms), float(la.extra_sfu)))
        self.work.clear()
        return out

    @contextlib.contextmanager
    def installed(self):
        m, t, o = self._merge, self._tables, self._ops
        saved = (m.merge_iteration, t.build_group_tables, o.merge_gain, o.pair_cost)
        m.merge_iteration = self._wrap_round(saved[0])
        t.build_group_tables = self._wrap_tables(saved[1])
        o.merge_gain = self._wrap_gain(saved[2])
        o.pair_cost = self._wrap_pair_cost(saved[3])
        try:
            yield self
        finally:
            m.merge_iteration, t.build_group_tables, o.merge_gain, o.pair_cost = saved

    def _capturing(self) -> bool:
        return self.round == self.capture_round

    def _launched(self, kernel: str) -> None:
        self.launches[kernel] = self.launches.get(kernel, 0) + 1

    def _wrap_round(self, fn):
        def merge_iteration(src, dst, state, cfg, theta, perms):
            self.round += 1
            if not self._capturing():
                with self.span("bench.round"):
                    return fn(src, dst, state, cfg, theta, perms)
            with self.span(CAPTURE_SPAN):
                self.cap = {"round": self.round,
                            "n2s_before": _host(state.node2super.to(torch.int32)),
                            "size_before": _host(state.size.to(torch.int32))}
            with self.span("bench.round"):
                new, stats = fn(src, dst, state, cfg, theta, perms)
            with self.span(CAPTURE_SPAN):
                self.cap.update(n2s_after=_host(new.node2super.to(torch.int32)),
                                size_after=_host(new.size.to(torch.int32)),
                                theta=_host(theta.reshape(())),
                                nmerges=_host(stats["nmerges"].reshape(())))
            return new, stats
        return merge_iteration

    def _wrap_tables(self, fn):
        def build_group_tables(*args, **kwargs):
            with self.span("bench.group_tables"):
                gt = fn(*args, **kwargs)
            if self._capturing():
                with self.span(CAPTURE_SPAN):
                    # groups with two live members or more first, in an order
                    # drawn from the seed
                    live = (gt.n > 0).sum(1) >= 2
                    key = torch.rand(live.shape[0], generator=self.gen, device=live.device)
                    key = torch.where(live, key, key + 2.0)
                    k = min(GROUPS, live.shape[0])
                    self.sel = torch.topk(key, k, largest=False).indices
                    self.cap["members"] = _host(gt.members[self.sel])
            return gt
        return build_group_tables

    def _wrap_gain(self, fn):
        def merge_gain(m, n, s, t, n_u, cidx, w, scal, **kwargs):
            with self.span("bench.merge_gain"):
                rel, red = fn(m, n, s, t, n_u, cidx, w, scal, **kwargs)
            self._launched("merge_gain")
            if self.counting:
                g, c, u = m.shape
                terms, pairs = roofline.merge_gain_work(torch, m, n, s, w)
                self.work.append(Launch("merge_gain", roofline.merge_gain_bytes(g, c, u),
                                        terms, pairs))
            if self._capturing():
                with self.span(CAPTURE_SPAN):
                    sel = self.sel
                    for name, x in (("m", m), ("n", n), ("s", s), ("t", t), ("n_u", n_u),
                                    ("cidx", cidx), ("w", w), ("rel", rel), ("red", red)):
                        self.cap[name] = _host(x[sel])
                    self.cap["scal"] = _host(scal)
            return rel, red
        return merge_gain

    def _wrap_pair_cost(self, fn):
        def pair_cost(cnt, pi, scal, **kwargs):
            with self.span("bench.pair_cost"):
                out = fn(cnt, pi, scal, **kwargs)
            self._launched("pair_cost")
            if self.counting:
                self.work.append(Launch("pair_cost", roofline.pair_cost_bytes(cnt, pi, out),
                                        roofline.pair_cost_work(cnt), 0.0))
            if self._capturing() and "rows" not in self.cap:
                with self.span(CAPTURE_SPAN):
                    # rows with an edge, in an order drawn from the seed
                    key = torch.rand(cnt.shape[0], generator=self.gen, device=cnt.device)
                    key = torch.where(cnt > 0, key, key + 2.0)
                    k = min(PAIR_ROWS, cnt.shape[0])
                    rows = torch.topk(key, k, largest=False).indices
                    self.cap.update(rows=_host(rows), pc_cnt=_host(cnt[rows]),
                                    pc_pi=_host(pi[rows]), pc_out=_host(out[rows]))
            return out
        return pair_cost
