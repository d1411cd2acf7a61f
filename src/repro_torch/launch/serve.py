"""Batched LM serving launcher of the port: continuous batching over fixed slots.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_14b --smoke \
        --requests 8 --prompt-len 32 --gen-len 32 [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_moe_3b_a800m ...
    PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot_v1_16b_a3b ...

Port of ``repro/launch/serve.py`` for the dense and MoE families (gemma,
qwen, danube, deepseek; granite-moe, moonshot). The scheduler packs
requests into fixed slots, keeps a decode position per slot, refills a
finished slot from the queue (continuous batching) and samples greedily;
every token, prompt tokens included, goes through the model's decode step
(``Model.serve_step``). Empty slots decode token 0, as the reference's do;
an MoE decode step is dropless, so they take no expert capacity from live
slots. It prints the reference's JSON result line plus
``device``, ``decode_steps`` and the median decode step. The reference's
mesh and sharding rules have no counterpart: the port serves on one device.
It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.api import build_model


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # int32 [L]
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class BatchServer:
    """Fixed-slot continuous-batching server over the Model API.

    Slots advance independently (a decode position per slot), so a request
    can be admitted into a free slot mid-flight: during admission the new
    slot teacher-forces its prompt while occupied slots keep their frozen
    position (their cache line there is rewritten by their own next real
    token, so no state leaks between requests). ``params`` (the port's
    parameter tree) replaces the seeded initialisation when given.
    ``step_s`` holds the wall of every decode step, the token ids read back."""

    def __init__(self, cfg, *, slots: int, max_len: int, seed: int = 0, params=None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.model = build_model(cfg, device)
        self.device = self.model.device
        self.slots = slots
        self.max_len = max_len
        self.params = self.model.init(seed) if params is None else params
        self.cache = self.model.init_cache(slots, max_len)
        self.pos = np.zeros(slots, np.int32)  # next position per slot
        self.active: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self.done: list[Request] = []
        self.step_s: list[float] = []

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _run(self, token: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode step; the greedy token of every slot (first index on ties)."""
        t0 = time.perf_counter()
        logits, self.cache = self.model.serve_step(self.params, {
            "token": torch.as_tensor(token, dtype=torch.int64, device=self.device),
            "pos": torch.as_tensor(np.minimum(pos, self.max_len - 1), dtype=torch.int64,
                                   device=self.device),
            "cache": self.cache})
        ids = torch.argmax(logits, dim=-1).cpu().numpy()
        self.step_s.append(time.perf_counter() - t0)
        return ids

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                self.active[s] = req
                # teacher-force the prompt through the decode path at this
                # slot's own positions; other slots' KV lines are safe by
                # masking. Recurrent state is not: such a family zeroes slot
                # s first and restores every other slot afterwards.
                snap = None
                if self.model.clear_slot is not None:
                    self.cache = self.model.clear_slot(self.cache, s)
                    snap = _clone(self.cache)
                for i, tok in enumerate(req.prompt):
                    token = np.zeros(self.slots, np.int32)
                    token[s] = tok
                    pos = self.pos.copy()
                    pos[s] = i
                    ids = self._run(token, pos)
                if snap is not None:
                    self.cache = self.model.restore_slots(self.cache, snap, s)
                self.pos[s] = len(req.prompt)
                req.out.append(int(ids[s]))
                req.t_first = time.perf_counter()

    def step(self) -> bool:
        """One decode step for every active slot. Returns False when idle."""
        self._admit()
        if all(a is None for a in self.active):
            return False
        token = np.zeros(self.slots, np.int32)
        for s, req in enumerate(self.active):
            if req is not None and req.out:
                token[s] = req.out[-1]
        ids = self._run(token, self.pos)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(ids[s]))
            self.pos[s] += 1
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_len - 1:
                req.t_done = time.perf_counter()
                self.done.append(req)
                self.active[s] = None
                self.pos[s] = 0  # slot reset for the next admission
        return True


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen2_5_14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(args.seed)
    server = BatchServer(cfg, slots=args.slots, max_len=args.max_len, seed=args.seed,
                         device=args.device)
    for rid in range(args.requests):
        server.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new=args.gen_len,
        ))
    t0 = time.perf_counter()
    while server.step():
        pass
    wall = time.perf_counter() - t0
    lat = [r.t_done - r.t_submit for r in server.done]
    ttft = [r.t_first - r.t_submit for r in server.done]
    toks = sum(len(r.out) for r in server.done)
    result = {
        "arch": cfg.name, "requests": len(server.done),
        "tokens": toks, "wall_s": wall,
        "tok_per_s": toks / max(wall, 1e-9),
        "p50_latency_s": float(np.median(lat)) if lat else None,
        "p50_ttft_s": float(np.median(ttft)) if ttft else None,
        "device": str(server.device), "decode_steps": len(server.step_s),
        "p50_decode_step_s": float(np.median(server.step_s)) if server.step_s else None,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
